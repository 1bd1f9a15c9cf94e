#!/usr/bin/env python3
"""Where the time of the PyTorch port's decode step goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_step.py [--steps 8] [--kv model|int8]

Builds the long-cache engine that `chip_smoke.py` phase 3 drives (1.5B,
random bf16 weights, B=1, prompt 256, 3840 steps -> a 4096-slot cache, 5-step
sde-dpmsolver++, cfg 1.3, forced diffusion), warms it up, then traces
`--steps` decode steps with `torch.profiler`.  Prints JSON lines: the host
wall time per step, the device's busy time per step (the union of its kernel
intervals) and its idle share, the launches per step, the device time of each
part of the step (LM, diffusion head, acoustic decoder, semantic encoder;
the kernels that start inside `record_function` ranges around the engine's
calls), and the kernels with the most device time; then the card's name and
power limit.  The profiler's own cost lengthens the host wall time.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _wrap(module, name, label):
    """Put `module.name` inside a profiler range called `label`."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)

    setattr(module, name, wrapped)


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _mark_parts():
    """Wrap the engine's calls into the LM, the diffusion head and the two
    codecs in profiler ranges."""
    from vibevoice_tpu_torch.engine import generate as G
    for mod, name, label in ((G.qwen2, "forward", "part:lm"),
                             (G.vibevoice, "sample_speech_latents", "part:diffusion_head"),
                             (G.tokenizer, "decoder_apply_streaming", "part:acoustic_decoder"),
                             (G.tokenizer, "encoder_apply_streaming", "part:semantic_encoder")):
        _wrap(mod, name, label)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kv", default="model", choices=["model", "int8"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V

    dev = G.resolve_device("cuda")
    cfg = vibevoice_1_5b()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    gen = G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=5, algorithm_type="sde-dpmsolver++",
        force_diffusion=True, max_length_times=64.0)
    eng = G.Engine(params, cfg, gen, max_steps=3840, batch=1, prompt_len=256,
                   dtype=torch.bfloat16, kv_dtype=args.kv, device=dev)
    ids = np.random.default_rng(0).integers(0, 1000, (1, 256)).astype(np.int32)
    state, _ = eng.prefill(ids, np.ones((1, 256), np.int32), np.zeros((1, 256), bool))
    state, _ = eng.decode_chunk(state, 8)
    torch.cuda.synchronize()

    _mark_parts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = eng.decode_chunk(state, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.steps

    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # the device side of each record_function range, and the kernels proper
    ranges = [(e.time_range.start, e.time_range.end, e.name[5:]) for e in cuda
              if e.name.startswith("part:")]
    kernels = [e for e in cuda if not e.name.startswith("part:")]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us = _busy_us(intervals)
    print(json.dumps({"kv": args.kv, "steps": n, "cache_slots": eng.cache_len,
                      "wall_ms_per_step": 1e3 * wall / n,
                      "device_busy_ms_per_step": busy_us / 1e3 / n,
                      "device_idle_share": 1 - busy_us / 1e6 / wall,
                      "kernel_launches_per_step": len(kernels) / n}), flush=True)

    # device busy time of the kernels that start inside each part's range
    parts = {name: 0.0 for _, _, name in ranges}
    parts["other"] = 0.0
    for s, e in intervals:
        name = next((r[2] for r in ranges if r[0] <= s < r[1]), "other")
        parts[name] += (e - s) / 1e3 / n
    print(json.dumps({"device_busy_ms_per_step_by_part": parts}), flush=True)

    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3 / n
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({"top_kernels_ms_per_step": [
        {"name": k[:90], "ms": v[0], "launches_per_step": v[1] / n} for k, v in top]}),
        flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
