"""The program's own tracer over a continuation of the cell's episodes, run
once in a `--trace 1` run for the readers of the `*.spans` metrics.

`traced(src)` sets a new `vibevoice_tpu_torch.utils.profiling.Tracer` on the
engine (which drops its captured step), takes one `decode_chunk(state, 1)`
(the traced capture: a warm-up step, then the step captured with timing
events at its parts' boundaries), then continues the episodes through the
program's `engine.generate.generate` for SECONDS, or to the episodes' end if
that comes first, handing it the current state as its first prefill
(`drivers.podcast.EngineProxy`).  The continuation runs as the window does:
4-step chunks, each read to the host, its frames counted and checked.  The
result is kept in `src` for the other readers.  On stderr (src["notes"]) it
prints the traced step (its parts' sum, first to last boundary event) against
step_ms.offline, the part samples taken and skipped, and the idle seconds by
host span.  None where the program has no tracer (`Engine.set_tracer`), off
CUDA, or under MIN_SAMPLES sampled replays.
"""
import time

import numpy as np

KEY = "program_trace"
SECONDS = 8.0
MIN_SAMPLES = 16
CHUNK = 4  # `generate`'s stream_chunk, as in the window
BUSY = ("engine.chunk", "engine.prefill")


def traced(src):
    if KEY not in src:
        src[KEY] = _run(src)
    return src[KEY]


def part_ms(src, part):
    """Mean device ms a step of `part` over the sampled replays."""
    t = traced(src)
    if t is None:
        return None
    return t["tracer"].sampled_ns[part] / t["samples"] / 1e6


def idle_pct(src):
    t = traced(src)
    if t is None:
        return None
    return 100.0 * t["idle_ns"] / t["wall_ns"]


def _run(src):
    eng, st, dev = src["engine"], src["state"], src["device"]
    if dev.type != "cuda" or not hasattr(eng, "set_tracer"):
        return None
    try:
        from vibevoice_tpu_torch.utils.profiling import Tracer
    except ImportError:
        return None
    from vibevoice_tpu_torch.engine import generate as G
    from .drivers.podcast import EngineProxy

    # the device's step counter: earlier readers stepped the engine past
    # the state's host mirror
    st = st._replace(host_step=int(st.step))
    if st.host_step + 4 * CHUNK >= eng.max_steps:
        return None
    tr = Tracer()
    eng.set_tracer(tr)
    frames = [0, 0]  # emitted, not finite

    def on_step(o):
        frames[0] += int(o.emitted.sum())
        frames[1] += int((o.emitted & ~np.isfinite(o.audio_chunk).all(axis=1)).sum())

    try:
        st, outs = eng.decode_chunk(st, 1)
        proxy = EngineProxy(eng, (st, G.StepOutput(*(x[0] for x in outs))))
        t0 = time.perf_counter_ns()
        deadline = t0 + int(SECONDS * 1e9)

        def stop_check():
            return (time.perf_counter_ns() >= deadline
                    or proxy.state.host_step + 2 * CHUNK >= eng.max_steps)

        G.generate(proxy, None, None, None, stop_check_fn=stop_check, on_step=on_step,
                   stream_chunk=CHUNK)
    finally:
        eng.set_tracer(None)
    t1 = tr.of("generate.finish")[-1].start_ns  # the loop's end
    samples = tr.counters["part_samples"]
    gaps = tr.idle_gaps(t0, t1, names=BUSY)
    idle_ns = sum(b - a for a, b, _ in gaps)
    by_host = {}
    for a, b, owner in gaps:
        by_host[owner] = by_host.get(owner, 0) + b - a
    notes = src["notes"]
    c = tr.counters
    notes.append(f"program trace: {samples} part samples taken, {c['part_samples_skipped']} "
                 f"skipped; {c['chunks']} chunks, {c['replays']} replays, {c['captures']} "
                 f"capture(s) (the last {eng.capture_s} s; packs {eng.pack_s} s); continuation "
                 f"{(t1 - t0) / 1e9:.4f} s, {frames[0]} frames ({frames[1]} not finite), "
                 f"{tr.dropped} spans dropped")
    if samples:
        parts = {p: ns / samples / 1e6 for p, ns in sorted(tr.sampled_ns.items())}
        step = sum(parts.values())
        off = src["metrics"].get("step_ms.offline")
        vs = f" against step_ms.offline {off:.4f} ms ({100 * (step / off - 1):+.3f}%)" if off \
            else ""
        notes.append(f"traced step {step:.4f} ms (the parts' sum: first to last boundary "
                     f"event){vs}; " + ", ".join(f"{p} {ms:.4f} ms ({100 * ms / step:.2f}%)"
                                                 for p, ms in parts.items()))
    notes.append(f"idle {idle_ns / 1e9:.4f} s of {(t1 - t0) / 1e9:.4f} s, by host span: "
                 + ", ".join(f"{k} {v / 1e9:.4f} s" for k, v in
                             sorted(by_host.items(), key=lambda x: -x[1])))
    if samples < MIN_SAMPLES:
        return None
    return {"tracer": tr, "samples": samples, "idle_ns": idle_ns, "wall_ns": t1 - t0}
