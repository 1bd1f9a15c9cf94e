"""The port's tracer: spans at the engine's own boundaries, on one clock.

A span is a name, a start and an end in `time.perf_counter_ns` nanoseconds,
its own id, the id of the span that caused it (its parent) and the id of the
request (`generate` call) it belongs to, on one of two tracks:

  * "host": the thread's own code, timed by the host clock;
  * "device": work on the device, from two stamps.  On a CUDA device a stamp
    is a timing event recorded on the stream, put on the host clock by an
    anchor (an event the tracer recorded, waited for, and read the host
    clock beside): an event's time is `anchor_ns + anchor.elapsed_time(event)`.
    On the CPU, where the device is the host, a stamp is the host clock.

Spans are kept in memory up to `cap`, past which `dropped` counts them;
per-name counts and totals are kept for every span.  `counters` counts at the
same boundaries (chunks, replays, captures, part samples taken and skipped).
A device span whose events are not done yet waits in a pending list until
`poll` finds them done (`flush` waits for them), so tracing adds no
synchronize to the traced program.

The engine (`engine/generate.py`) records its prefills and chunks as device
spans, a step's parts (`PARTS`) from boundary stamps (`step_spans`), and the
`generate` loop its host spans.  `summary()`, `idle_gaps()` and
`export_chrome()` read the result.  One tracer serves one thread.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

HOST, DEVICE = "host", "device"
# a decode step's parts, in the order the step runs them ("rest" is every
# operation between and after the others: it is recorded as more than one
# segment of a step)
PARTS = ("lm", "head", "acoustic_decoder", "semantic_encoder", "rest")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    track: str

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _union(intervals) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


class Tracer:
    """Host and device spans, counters and per-name totals (module docstring)."""

    def __init__(self, cap: int = 1 << 20):
        self.cap = cap
        self.spans: List[Span] = []
        self.dropped = 0
        self.counters: Dict[str, int] = defaultdict(int)
        # (track, name) -> [count, total ns], over every span, kept or dropped
        self.totals: Dict[Tuple[str, str], List[int]] = defaultdict(lambda: [0, 0])
        # part -> total ns over the sampled replays (`counters["part_samples"]`)
        self.sampled_ns: Dict[str, int] = defaultdict(int)
        self.request_id: Optional[int] = None
        self._next = 0
        self._stack: List[int] = []  # open host spans
        self._anchor = None          # (event, host ns)
        self._pending: list = []     # (specs, end event, events to pool)
        self._pool: list = []

    # ---- spans -------------------------------------------------------
    def new_id(self) -> int:
        self._next += 1
        return self._next

    def current(self) -> Optional[int]:
        """The innermost open host span."""
        return self._stack[-1] if self._stack else None

    def add(self, name: str, start_ns: int, end_ns: int, track: str = HOST,
            parent: Optional[int] = None, id: Optional[int] = None) -> int:
        """Record a finished span of the current request."""
        sid = self.new_id() if id is None else id
        self._keep(Span(name, start_ns, end_ns, sid, parent, self.request_id, track))
        return sid

    def _keep(self, s: Span):
        tot = self.totals[(s.track, s.name)]
        tot[0] += 1
        tot[1] += s.ns
        if len(self.spans) < self.cap:
            self.spans.append(s)
        else:
            self.dropped += 1

    @contextlib.contextmanager
    def span(self, name: str, request: bool = False) -> Iterator[int]:
        """A host span around the block, a child of the innermost open one;
        with `request`, the block is a new request whose id is this span's."""
        sid, parent, req = self.new_id(), self.current(), self.request_id
        if request:
            self.request_id = sid
        self._stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield sid
        finally:
            t1 = time.perf_counter_ns()
            self._stack.pop()
            self.add(name, t0, t1, HOST, parent, sid)
            self.request_id = req

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    # ---- the device's clock ------------------------------------------
    def anchor(self, device=None, event=None, host_ns: Optional[int] = None):
        """Tie the device's clock to the host's: record an event on
        `device`'s current stream, wait for it and read the host clock.  A
        test hands in its own `event` and `host_ns`.  A second call on an
        anchored tracer keeps the first anchor."""
        if self._anchor is not None:
            return
        if event is None:
            import torch
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
            host_ns = time.perf_counter_ns()
        self._anchor = (event, host_ns)

    def to_ns(self, stamp) -> int:
        """A stamp on the host clock: host nanoseconds as they are, a timing
        event through the anchor."""
        if isinstance(stamp, int):
            return stamp
        ev, ns = self._anchor
        return ns + round(ev.elapsed_time(stamp) * 1e6)

    def stamp(self):
        """A stamp of now on the device: a timing event from the pool
        recorded on the current stream, or the host clock on an unanchored
        (CPU) tracer."""
        if self._anchor is None:
            return time.perf_counter_ns()
        if self._pool:
            ev = self._pool.pop()
        else:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def device_span(self, name: str, begin, end, parent: Optional[int] = None,
                    id: Optional[int] = None) -> int:
        """A device span between two stamps from `stamp()`; with events, it
        is recorded once they are done (`poll`), and they go back to the
        pool."""
        sid = self.new_id() if id is None else id
        self._defer([(sid, name, parent, self.request_id, begin, end)], end, (begin, end))
        return sid

    def step_spans(self, marks, parent: Optional[int] = None, replay: bool = False):
        """The spans of one step from its part boundaries `marks`, [(part,
        stamp)] in order, the first part None (the step's start): a device
        span "engine.step" from the first stamp to the last, and one for each
        segment, named by the part that ends it.  With `replay`, the stamps
        are a captured graph's own events, done now and overwritten by its
        next replay: they are read now, kept, and the step counts as a part
        sample; else they are pool stamps, recorded once done."""
        step, req = self.new_id(), self.request_id
        specs = [(step, "engine.step", parent, req, marks[0][1], marks[-1][1])]
        specs += [(self.new_id(), part, step, req, a, b)
                  for (_, a), (part, b) in zip(marks, marks[1:])]
        if not replay:
            self._defer(specs, marks[-1][1], [s for _, s in marks])
            return
        self._record(specs)
        self.count("part_samples")
        t = [self.to_ns(s) for _, s in marks]
        for (part, _), a, b in zip(marks[1:], t, t[1:]):
            self.sampled_ns[part] += b - a

    def _defer(self, specs, end, stamps):
        if isinstance(end, int):
            self._record(specs)
        else:
            self._pending.append((specs, end, stamps))
            self.poll()

    def _record(self, specs):
        for sid, name, parent, req, a, b in specs:
            self._keep(Span(name, self.to_ns(a), self.to_ns(b), sid, parent, req, DEVICE))

    def poll(self, wait: bool = False):
        """Record the pending device spans whose events are done (with
        `wait`, all of them, waiting for their events)."""
        keep = []
        for specs, end, stamps in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((specs, end, stamps))
                continue
            self._record(specs)
            self._pool.extend(stamps)
        self._pending = keep

    def flush(self):
        self.poll(wait=True)

    # ---- reading -----------------------------------------------------
    def of(self, name: str, track: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.name == name and track in (None, s.track)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per track and name ("host:generate.read", "device:lm"): count,
        total and mean ms over every span, and self ms over the spans kept:
        a span's duration less the part of it its children on the same
        track cover."""
        self.flush()
        children = defaultdict(list)
        for s in self.spans:
            children[s.parent].append(s)
        self_ns: Dict[Tuple[str, str], int] = defaultdict(int)
        for s in self.spans:
            kids = [(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                    for c in children[s.id] if c.track == s.track]
            covered = sum(e - b for b, e in _union(k for k in kids if k[1] > k[0]))
            self_ns[(s.track, s.name)] += s.ns - covered
        return {f"{track}:{name}": {"count": n, "total_ms": ns / 1e6, "mean_ms": ns / 1e6 / n,
                                    "self_ms": self_ns[(track, name)] / 1e6}
                for (track, name), (n, ns) in sorted(self.totals.items())}

    def busy(self, names=None) -> List[Tuple[int, int]]:
        """The union of the kept device spans (those named in `names`)."""
        self.flush()
        return _union((s.start_ns, s.end_ns) for s in self.spans
                      if s.track == DEVICE and (names is None or s.name in names))

    def idle_gaps(self, start_ns: int, end_ns: int, names=None) -> List[Tuple[int, int, str]]:
        """Each interval of [start_ns, end_ns) in which no device span (of
        `names`) runs, with the host span it is put down to: the one whose
        own time (less its host children) overlaps the gap most, else
        "other"."""
        gaps, t = [], start_ns
        for s, e in self.busy(names):
            if s > t:
                gaps.append((t, min(s, end_ns)))
            t = max(t, e)
            if t >= end_ns:
                break
        if t < end_ns:
            gaps.append((t, end_ns))
        gaps = [(a, b) for a, b in gaps if b > a]
        host = [s for s in self.spans if s.track == HOST]
        kids = defaultdict(list)
        for s in host:
            kids[s.parent].append(s)
        out = []
        for a, b in gaps:
            best, owner = 0, "other"
            for s in host:
                own = _overlap(s.start_ns, s.end_ns, a, b)
                if own <= best:
                    continue
                own -= sum(_overlap(c.start_ns, c.end_ns, a, b) for c in kids[s.id])
                if own > best:
                    best, owner = own, s.name
            out.append((a, b, owner))
        return out

    def export_chrome(self, path: str):
        """The kept spans as a Chrome trace (chrome://tracing, Perfetto):
        host spans on one track, device spans on another, in microseconds of
        the host clock; each span's id, parent and request in its args, the
        counters and `dropped` in `otherData`."""
        self.flush()
        tid = {HOST: 0, DEVICE: 1}
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": i, "args": {"name": t}}
                  for t, i in tid.items()]
        events += [{"name": s.name, "ph": "X", "pid": 0, "tid": tid[s.track],
                    "ts": s.start_ns / 1e3, "dur": s.ns / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "request": s.request}}
                   for s in self.spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": dict(self.counters),
                                     "dropped": self.dropped}}, f)


__all__ = ["Tracer", "Span", "PARTS", "HOST", "DEVICE"]
