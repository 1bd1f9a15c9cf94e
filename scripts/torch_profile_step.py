#!/usr/bin/env python3
"""Where the time of the PyTorch port's decode step goes, on one NVIDIA GPU,
read from the program's own tracer (`vibevoice_tpu_torch.utils.profiling`).

    python3 scripts/torch_profile_step.py [--steps 256] [--kv model|int8] [--quant int4|int4f]
                                          [--stages] [--chain] [--trace_out PATH]

Builds the long-cache engine that `chip_smoke.py` phase 3 drives (1.5B,
random bf16 weights, B=1, prompt 256, 3840 steps -> a 4096-slot cache, 5-step
sde-dpmsolver++, cfg 1.3, forced diffusion); with `--quant` the weights first
go through `VibeVoiceTTS(quantize=..., quantize_tokenizer="int4k",
quantize_diffusion="int4k")`, as in `chip_smoke.py` phase 5; `--stages` turns
on `use_fused_stages` (the large-T sigma-VAE stages on the fused stage
kernel, the transition convs folded at B=1); `--chain` turns on
`use_fused_chains` on the bf16 weights (the small-T stages on the plain-pack
chain kernel, as `chip_smoke.py`'s long-prompt engine runs them; with
`--quant` they run the int4 chain packs in the params).  The engine runs the captured step, as users run it, with
a tracer set: the graph records timing events at the step's part boundaries,
and each 4-step chunk of `generate` reads the last replay of the chunk
before.  It runs one request of `--steps` decode steps, then prints JSON
lines, from the second chunk on (the first captures the step): the host
wall time per step, the device's busy time per step (the chunks' device
spans) and its idle share; the mean device ms a step of each
part (LM, diffusion head, acoustic decoder, semantic encoder, the rest) over
the sampled replays; the host spans' counts and times; the idle seconds by
the host span they fall in; the capture's and the packs' seconds and the
tracer's counters; then the card's name and power limit.  `--trace_out`
writes the spans as a Chrome trace (chrome://tracing, Perfetto), host and
device on two tracks of one timeline.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

CHUNK = 4  # steps a chunk, as `generate` streams

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--kv", default="model", choices=["model", "int8"])
    ap.add_argument("--quant", default=None, choices=["int4", "int4f"])
    ap.add_argument("--stages", action="store_true", help="use_fused_stages=True")
    ap.add_argument("--chain", action="store_true",
                    help="use_fused_chains (plain packs)")
    ap.add_argument("--trace_out", default=None, help="write the spans as a Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device", file=sys.stderr)
        return 2
    if args.chain and args.quant:
        raise SystemExit("--chain runs the plain packs of unquantized weights; drop --quant")
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.utils.profiling import HOST, PARTS, Tracer

    dev = G.resolve_device("cuda")
    cfg = vibevoice_1_5b()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    if args.quant:
        from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
        from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
        params = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.bfloat16,
                              device=dev, quantize=args.quant, quantize_tokenizer="int4k",
                              quantize_diffusion="int4k").params
    gen = G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=5, algorithm_type="sde-dpmsolver++",
        force_diffusion=True, max_length_times=64.0)
    tr = Tracer()
    eng = G.Engine(params, cfg, gen, max_steps=3840, batch=1, prompt_len=256,
                   dtype=torch.bfloat16, kv_dtype=args.kv, device=dev,
                   use_fused_chains=args.chain, use_fused_stages=args.stages, tracer=tr)
    ids = np.random.default_rng(0).integers(0, 1000, (1, 256)).astype(np.int32)
    steps = [0]

    def on_step(o):
        steps[0] += 1

    G.generate(eng, ids, np.ones((1, 256), np.int32), np.zeros((1, 256), bool),
               on_step=on_step, stop_check_fn=lambda: steps[0] > args.steps,
               stream_chunk=CHUNK)
    eng.set_tracer(None)  # reads the last chunk's replay
    # from the second chunk (the first captures the step) to the loop's end
    chunks = tr.of("engine.decode_chunk", HOST)
    t0, t1 = chunks[1].start_ns, tr.of("generate.finish")[-1].start_ns
    n = CHUNK * (len(chunks) - 1)
    gaps = tr.idle_gaps(t0, t1, {"engine.chunk", "engine.prefill"})
    busy = t1 - t0 - sum(b - a for a, b, _ in gaps)
    samples = tr.counters["part_samples"]
    print(json.dumps({"kv": args.kv, "quant": args.quant, "fused_stages": args.stages,
                      "plain_chain": args.chain, "steps": n, "cache_slots": eng.cache_len,
                      "wall_ms_per_step": (t1 - t0) / 1e6 / n,
                      "device_busy_ms_per_step": busy / 1e6 / n,
                      "device_idle_share": 1 - busy / (t1 - t0)}), flush=True)
    parts = {p: tr.sampled_ns[p] / 1e6 / max(samples, 1) for p in PARTS}
    print(json.dumps({"device_ms_per_step_by_part": parts, "step_ms": sum(parts.values()),
                      "part_samples": samples,
                      "part_samples_skipped": tr.counters["part_samples_skipped"]}), flush=True)
    print(json.dumps({"host_spans": {k[5:]: v for k, v in tr.summary().items()
                                     if k.startswith("host:")}}), flush=True)
    idle = {}
    for a, b, owner in gaps:
        idle[owner] = idle.get(owner, 0.0) + (b - a) / 1e9
    print(json.dumps({"idle_s_by_host_span": idle}), flush=True)
    print(json.dumps({"capture_s": eng.capture_s, "pack_s": eng.pack_s,
                      "counters": dict(tr.counters), "spans_dropped": tr.dropped}), flush=True)
    if args.trace_out:
        tr.export_chrome(args.trace_out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
