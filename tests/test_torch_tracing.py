"""The port's tracer (`vibevoice_tpu_torch.utils.profiling.Tracer`) and the
engine's spans, on the CPU: nesting, request ids and self time, the device
clock through the anchor (a fake event clock), idle gaps, the Chrome export,
the cap, and a tiny engine's step parts and `generate` spans, with the
outputs bit-equal with the tracer on and off.  The captured step's events are
tested on the card (`tests/test_torch_cuda.py`)."""
import json

import numpy as np
import torch

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.utils.profiling import DEVICE, HOST, PARTS, Tracer

B, T, STEPS = 2, 16, 12


class FakeEvent:
    """A timing event on a fake device clock (ms), done once `done` is set."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done, self.waited = t_ms, done, False

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def _anchored(host_ns=1_000_000_000, t_ms=50.0):
    tr = Tracer()
    tr.anchor(event=FakeEvent(t_ms), host_ns=host_ns)
    return tr


def test_spans_nest_with_parents_requests_and_self_time():
    tr = Tracer()
    with tr.span("generate", request=True) as req:
        with tr.span("generate.read") as read:
            with tr.span("inner") as inner:
                pass
        with tr.span("generate.feed"):
            pass
    with tr.span("outside"):
        pass
    by = {s.name: s for s in tr.spans}
    assert by["generate"].parent is None and by["generate"].request == req
    assert by["generate.read"].parent == req and by["inner"].parent == read
    assert by["generate.feed"].parent == req and by["inner"].id == inner
    assert {by[n].request for n in ("generate.read", "inner", "generate.feed")} == {req}
    assert by["outside"].request is None and tr.request_id is None
    g = by["generate"]
    assert g.start_ns <= by["generate.read"].start_ns <= by["inner"].end_ns <= g.end_ns

    tr = Tracer()
    p = tr.add("parent", 0, 100)
    tr.add("child", 10, 30, parent=p)
    tr.add("child", 20, 50, parent=p)   # overlaps the first: covered once
    tr.add("child", 90, 130, parent=p)  # runs past the parent: clipped
    tr.add("device", 0, 100, DEVICE, parent=p)  # another track: not a child here
    s = tr.summary()
    assert s["host:parent"] == {"count": 1, "total_ms": 100e-6, "mean_ms": 100e-6,
                                "self_ms": 50e-6}
    assert s["host:child"]["count"] == 3 and s["host:child"]["self_ms"] == 90e-6
    assert s["device:device"]["self_ms"] == 100e-6


def test_device_events_map_to_the_host_clock_through_the_anchor():
    tr = _anchored(host_ns=1_000_000_000, t_ms=50.0)
    assert tr.to_ns(FakeEvent(51.5)) == 1_001_500_000
    assert tr.to_ns(FakeEvent(49.0)) == 999_000_000  # before the anchor
    assert tr.to_ns(123) == 123  # host nanoseconds pass as they are
    tr.anchor(event=FakeEvent(0.0), host_ns=0)  # a second anchor keeps the first
    assert tr.to_ns(FakeEvent(50.0)) == 1_000_000_000
    sid = tr.device_span("engine.chunk", FakeEvent(52.0), FakeEvent(55.25), parent=7)
    (s,) = tr.spans
    assert (s.name, s.track, s.id, s.parent) == ("engine.chunk", DEVICE, sid, 7)
    assert (s.start_ns, s.end_ns) == (1_002_000_000, 1_005_250_000)


def test_device_spans_wait_for_their_events_without_a_synchronize():
    tr = _anchored()
    end = FakeEvent(60.0, done=False)
    begin = FakeEvent(58.0)
    with tr.span("generate", request=True) as req:
        tr.device_span("engine.chunk", begin, end)
    assert [s.name for s in tr.spans] == ["generate"] and not end.waited  # pending
    tr.poll()
    assert len(tr.spans) == 1
    end.done = True
    tr.poll()  # after the request: the span keeps the request it was made in
    assert [(s.name, s.request) for s in tr.spans[1:]] == [("engine.chunk", req)]
    assert not end.waited
    assert set(map(id, tr._pool)) == {id(begin), id(end)}  # back to the pool
    late = FakeEvent(70.0, done=False)
    tr.device_span("engine.prefill", FakeEvent(69.0), late)
    tr.flush()  # waits
    assert late.waited and tr.spans[-1].name == "engine.prefill" and tr.spans[-1].request is None


def test_replayed_step_parts_are_read_now_and_counted_as_samples():
    tr = _anchored(host_ns=0, t_ms=0.0)
    times = [0.0, 4.0, 4.5, 7.0, 9.0, 9.5, 10.0]
    names = [None, "lm", "rest", "head", "acoustic_decoder", "semantic_encoder", "rest"]
    marks = [(n, FakeEvent(t)) for n, t in zip(names, times)]
    for _ in range(2):
        tr.step_spans(marks, parent=3, replay=True)
    assert tr.counters["part_samples"] == 2 and tr._pool == []  # the graph keeps its events
    assert dict(tr.sampled_ns) == {"lm": 8_000_000, "rest": 2_000_000, "head": 5_000_000,
                                   "acoustic_decoder": 4_000_000,
                                   "semantic_encoder": 1_000_000}
    steps = tr.of("engine.step")
    assert [(s.parent, s.start_ns, s.end_ns) for s in steps] == [(3, 0, 10_000_000)] * 2
    for step in steps:
        assert [s.name for s in tr.spans if s.parent == step.id] == names[1:]


def test_idle_gaps_go_to_the_host_span_that_overlaps_them_most():
    tr = Tracer()
    g = tr.add("generate", 0, 1000)
    tr.add("engine.chunk", 100, 400, DEVICE)
    tr.add("engine.chunk", 420, 900, DEVICE)
    tr.add("engine.chunk", 850, 950, DEVICE)  # overlaps the one before: one busy stretch
    tr.add("generate.feed", 395, 415, parent=g)  # most of the gap 400-420
    tr.add("generate.stop_check", 415, 425, parent=g)
    tr.add("generate.read", 940, 960, parent=g)  # 10 of the gap 950-990; "generate" own 30
    gaps = tr.idle_gaps(50, 990)
    assert gaps == [(50, 100, "generate"), (400, 420, "generate.feed"),
                    (950, 990, "generate")]
    assert tr.idle_gaps(0, 50) == [(0, 50, "generate")]
    assert Tracer().idle_gaps(0, 10) == [(0, 10, "other")]
    only = tr.idle_gaps(100, 400, names={"engine.prefill"})
    assert only == [(100, 400, "generate")]


def test_chrome_export_round_trips(tmp_path):
    tr = _anchored(host_ns=2_000_000_000, t_ms=0.0)
    with tr.span("generate", request=True) as req:
        with tr.span("engine.decode_chunk") as host:
            tr.device_span("engine.chunk", FakeEvent(1.0), FakeEvent(3.5), parent=host)
    tr.count("chunks")
    path = tmp_path / "trace.json"
    tr.export_chrome(str(path))
    data = json.loads(path.read_text())
    names = {e["args"]["name"]: e["tid"] for e in data["traceEvents"] if e["ph"] == "M"}
    assert names == {HOST: 0, DEVICE: 1}
    got = sorted((e["name"], e["tid"], round(e["ts"] * 1e3), round(e["dur"] * 1e3),
                  e["args"]["id"], e["args"]["parent"], e["args"]["request"])
                 for e in data["traceEvents"] if e["ph"] == "X")
    want = sorted((s.name, {HOST: 0, DEVICE: 1}[s.track], s.start_ns, s.ns, s.id, s.parent,
                   s.request) for s in tr.spans)
    assert got == want and len(got) == 3
    assert [g[6] for g in got] == [req] * 3
    assert data["otherData"] == {"counters": {"chunks": 1}, "dropped": 0}


def test_cap_drops_spans_and_counts_them_but_keeps_totals():
    tr = Tracer(cap=3)
    for i in range(5):
        with tr.span("generate.read"):
            pass
    tr.add("engine.chunk", 0, 10, DEVICE)
    assert len(tr.spans) == 3 and tr.dropped == 3
    s = tr.summary()
    assert s["host:generate.read"]["count"] == 5 and s["device:engine.chunk"]["count"] == 1
    assert s["device:engine.chunk"]["total_ms"] == 10e-6


# ---------------------------------------------------------------------------
# the engine and generate on the CPU
# ---------------------------------------------------------------------------

def _engine(tracer=None, eager=False):
    cfg = tiny_config(vocab_size=320)
    params = V.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params["speech_scaling_factor"] = torch.tensor(1.0)
    params["speech_bias_factor"] = torch.tensor(0.0)
    gen = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                             eos_id=256, ddpm_steps=2, force_diffusion=True,
                             max_length_times=64.0)
    return G.Engine(params, cfg, gen, max_steps=STEPS, batch=B, prompt_len=T, device="cpu",
                    inject_latent_noise=True, tracer=tracer, eager=eager)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 250, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    noise = rng.normal(size=(STEPS, B, 8)).astype(np.float32)
    return ids, mask, np.zeros((B, T), bool), noise


def _request(eng, chunks=(3, 4)):
    ids, mask, sim, noise = _inputs()
    state, out = eng.prefill(ids, mask, sim, latent_noise=noise,
                             generator=torch.Generator().manual_seed(1))
    outs = [G.StepOutput(*(x[None] for x in out))]
    for n in chunks:
        state, o = eng.decode_chunk(state, n)
        outs.append(o)
    return G.StepOutput(*(torch.cat(x) for x in zip(*outs))), state


def _assert_equal(a, b):
    (ao, astate), (bo, bstate) = a, b
    for name, x, y in zip(G.StepOutput._fields, ao, bo):
        assert torch.equal(x, y), name
    for name in ("audio", "tokens", "frames", "cur_embeds"):
        assert torch.equal(getattr(astate, name), getattr(bstate, name)), name


def _parts_of(tr, step):
    return sorted((s for s in tr.spans if s.parent == step.id), key=lambda s: s.start_ns)


def test_eager_engine_records_five_parts_a_step_under_one_step_span():
    tr = Tracer()
    traced = _request(_engine(tr))
    _assert_equal(traced, _request(_engine()))
    assert tr.of("engine.pack", HOST) and tr.counters["chunks"] == 2
    assert tr.counters["replays"] == 0 and tr.counters["part_samples"] == 0
    (prefill,) = tr.of("engine.prefill", DEVICE)
    chunks = tr.of("engine.chunk", DEVICE)
    steps = tr.of("engine.step", DEVICE)
    assert len(chunks) == 2 and len(steps) == 1 + 3 + 4
    assert [s.parent for s in steps] == [prefill.id] + [chunks[0].id] * 3 + [chunks[1].id] * 4
    for i, step in enumerate(steps):
        parts = _parts_of(tr, step)
        want = (["rest"] if i == 0 else ["lm", "rest"]) + [
            "head", "acoustic_decoder", "semantic_encoder", "rest"]
        assert [p.name for p in parts] == want  # the prefill's step 0 runs no decode LM
        assert parts[0].start_ns == step.start_ns and parts[-1].end_ns == step.end_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(parts, parts[1:]))
        assert set(p.name for p in parts) <= set(PARTS)
        owner = prefill if i == 0 else chunks[0 if i <= 3 else 1]
        assert owner.start_ns <= step.start_ns and step.end_ns <= owner.end_ns


def test_generate_records_its_host_spans_once_a_chunk():
    tr = Tracer()
    eng = _engine(tr)
    ids, mask, sim, noise = _inputs()
    fed = []
    res = G.generate(eng, ids, mask, sim, latent_noise=noise, on_step=fed.append,
                     stream_chunk=4, generator=torch.Generator().manual_seed(1))
    chunks = tr.counters["chunks"]
    assert chunks == -(-(STEPS - 1) // 4) and res.steps == STEPS and len(fed) == STEPS
    (req,) = tr.of("generate", HOST)
    counts = {n: len(tr.of(n, HOST)) for n in (
        "engine.prefill.host", "engine.decode_chunk", "generate.read", "generate.feed",
        "generate.stop_check", "generate.finish")}
    # the prefill's output is read and fed once too; the loop ends on max_steps
    assert counts == {"engine.prefill.host": 1, "engine.decode_chunk": chunks,
                      "generate.read": chunks + 1, "generate.feed": chunks + 1,
                      "generate.stop_check": chunks, "generate.finish": 1}
    assert len(tr.of("engine.prefill", DEVICE)) == 1
    assert all(s.request == req.id for s in tr.spans if s.name != "engine.pack")
    for host in tr.of("engine.decode_chunk", HOST):
        (dev,) = [s for s in tr.spans if s.parent == host.id]
        assert dev.name == "engine.chunk" and dev.track == DEVICE
    assert len(tr.of("engine.step")) == STEPS  # step 0 in the prefill, then one a step

    # stopped by stop_check_fn after two chunks: one more stop test than chunks
    tr2 = Tracer()
    calls = []
    G.generate(_engine(tr2), ids, mask, sim, latent_noise=noise, on_step=lambda o: None,
               stop_check_fn=lambda: calls.append(1) or len(calls) > 2)
    assert tr2.counters["chunks"] == 2 and len(tr2.of("generate.stop_check")) == 3


def test_set_tracer_none_leaves_the_outputs_unchanged():
    plain = _request(_engine())
    eng = _engine(Tracer())
    eng.set_tracer(None)
    assert eng.tracer is None
    _assert_equal(_request(eng), plain)
    tr = Tracer()
    eng.set_tracer(tr)
    _assert_equal(_request(eng), plain)
    assert tr.counters["chunks"] == 2 and not tr.of("engine.pack")
    eager = _engine(eager=True)
    eager.set_tracer(None)
    _assert_equal(_request(eager), plain)
