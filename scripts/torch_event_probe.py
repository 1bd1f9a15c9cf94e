#!/usr/bin/env python3
"""Whether timing events recorded inside a captured CUDA graph read that
replay's device time, and what the port's tracer costs the captured step, on
one NVIDIA GPU.

    python3 scripts/torch_event_probe.py [--replays 50] [--turns 4]

Captures a step-like body (K parts, each many small launch-bound kernels and
a few matmuls) in a `torch.cuda.CUDAGraph`, with
`torch.cuda.Event(enable_timing=True, external=True)` recorded at the K+1
part boundaries (under capture these become event-record nodes).  For each
replay it holds the span from the first to the last boundary event, and the
sum of the parts, against plain timing events recorded on the stream around
`graph.replay()`.  Also: the graph's nodes with and without the events
(`cuGraphGetNodes`), whether the last event reads incomplete before a
synchronize and complete after, whether a boundary event's time against an
anchor event recorded outside the graph falls inside the plain span, and
whether each replay's events are overwritten by the next replay.

Then the tracer's cost on the port's engine at the batch CLI's shape (1.5B,
random bf16 weights, B=8, a 2304-token prompt, 4608 steps -> an 8192-slot
cache, 10 dpmsolver++ steps, cfg 1.3, forced diffusion): in turns untraced,
traced, traced, untraced (`--turns` times each), the step captured again
(`Engine.set_tracer`) and 32 back-to-back replays timed by events around
them; a traced turn also gives its last replay's parts from the tracer.
Prints JSON lines, then the card's name and power limit; exits 1 when the
span misses the plain events by more than 2%.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARTS = 5


def graph_nodes(graph) -> int:
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    return n.value


def body(xs, w, marks=None):
    """K parts of launch-bound elementwise ops and matmuls."""
    x, y = xs
    for k in range(PARTS):
        for _ in range(100 * (k + 1)):
            x = x * 0.999 + 0.001
        for _ in range(k + 1):
            y = (y @ w).tanh()
        if marks is not None:
            marks[k + 1].record()
    xs[0].copy_(x)
    xs[1].copy_(y)


def capture(xs, w, events: bool):
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body(xs, w)
    torch.cuda.current_stream().wait_stream(stream)
    marks = [torch.cuda.Event(enable_timing=True, external=True)
             for _ in range(PARTS + 1)] if events else None
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        if marks is not None:
            marks[0].record()
        body(xs, w, marks)
    graph.instantiate()
    return graph, marks


def engine_turns(turns: int) -> dict:
    """ms a replay of the 1.5B B=8 step, untraced and traced, in turns."""
    import numpy as np
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.utils.profiling import Tracer

    dev = G.resolve_device("cuda")
    cfg = vibevoice_1_5b()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    gen = G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=10, force_diffusion=True,
        max_length_times=64.0)
    b, t = 8, 2304
    eng = G.Engine(params, cfg, gen, max_steps=4608, batch=b, prompt_len=t,
                   dtype=torch.bfloat16, device=dev)
    ids = np.random.default_rng(0).integers(0, 1000, (b, t)).astype(np.int32)
    state, _ = eng.prefill(ids, np.ones((b, t), np.int32), np.zeros((b, t), bool))
    out = {"untraced": [], "traced": [], "traced_parts_sum": [], "nodes": {}}
    for traced in [False, True, True, False] * turns:
        tr = Tracer() if traced else None
        eng.set_tracer(tr)
        state, _ = eng.decode_chunk(state, 1)  # the capture
        state, _ = eng.decode_chunk(state, 4)
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        state, _ = eng.decode_chunk(state, 32)
        z.record()
        z.synchronize()
        out["traced" if traced else "untraced"].append(a.elapsed_time(z) / 32)
        out["nodes"]["traced" if traced else "untraced"] = graph_nodes(eng.graph)
        if traced:
            state, _ = eng.decode_chunk(state, 1)  # reads the last replay of the 32
            out["traced_parts_sum"].append(sum(tr.sampled_ns.values()) / 1e6
                                           / tr.counters["part_samples"])
    eng.set_tracer(None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replays", type=int, default=50)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_event_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn((16, 1536), device=dev, generator=gen),
          torch.randn((2048, 2048), device=dev, generator=gen, dtype=torch.bfloat16)]
    w = (torch.randn((2048, 2048), device=dev, generator=gen) / 45).bfloat16()
    plain_graph, _ = capture(xs, w, events=False)
    graph, marks = capture(xs, w, events=True)
    nodes = (graph_nodes(plain_graph), graph_nodes(graph))
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()

    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    anchor.synchronize()
    rows, inside, incomplete, overwritten = [], 0, 0, 0
    prev_last = None
    for _ in range(args.replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # the device busy while the host enqueues
        a.record()
        graph.replay()
        b.record()
        incomplete += not marks[-1].query()
        b.synchronize()
        plain = a.elapsed_time(b)
        span = marks[0].elapsed_time(marks[-1])
        parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(PARTS)]
        t_a, t0, t1, t_b = (anchor.elapsed_time(e) for e in (a, marks[0], marks[-1], b))
        inside += t_a <= t0 <= t1 <= t_b
        if prev_last is not None:
            overwritten += t1 > prev_last
        prev_last = t1
        rows.append((plain, span, sum(parts), parts))
    plain_ms = statistics.median(r[0] for r in rows)
    span_ms = statistics.median(r[1] for r in rows)
    sum_ms = statistics.median(r[2] for r in rows)
    worst = max(abs(r[1] - r[0]) / r[0] for r in rows)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "replays": args.replays,
           "nodes_plain": nodes[0], "nodes_with_events": nodes[1],
           "added_nodes": nodes[1] - nodes[0], "boundary_events": PARTS + 1,
           "plain_ms_median": plain_ms, "span_ms_median": span_ms,
           "parts_sum_ms_median": sum_ms, "span_over_plain": span_ms / plain_ms,
           "worst_rel_diff": worst,
           "parts_ms_median": [statistics.median(r[3][i] for r in rows) for i in range(PARTS)],
           "span_inside_plain": inside, "last_incomplete_before_sync": incomplete,
           "overwritten_by_next_replay": overwritten}
    print(json.dumps(out), flush=True)
    cost = engine_turns(args.turns)
    cost.update({k + "_median": statistics.median(cost[k])
                 for k in ("untraced", "traced", "traced_parts_sum")})
    cost["traced_over_untraced"] = cost["traced_median"] / cost["untraced_median"]
    print(json.dumps(cost), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0 if abs(span_ms / plain_ms - 1) <= 0.02 else 1


if __name__ == "__main__":
    sys.exit(main())
