"""Prepare a serving rollout on the card: build every kernel library ahead
of time, then build and warm the serving engines over a shape grid.

The port of `scripts/warm_serving_cache.py`, which fills the JAX compilation
cache.  Here the kernel libraries (`ops/cuda_build.build_all`, into
`cuda_build.build_dir()` or `--build_dir`) are the only artifact that
outlives the process: a serving process that finds them there starts
without nvcc.  The CUDA graphs that `tts.warm` captures (one per engine)
die with this process, and a server captures its own at start-up
(`python -m vibevoice_tpu_torch.serving`, which warms by default); run this
once per rollout to build the libraries and to check that every engine of
the grid builds, prefills and captures on the card:

  python -m vibevoice_tpu_torch.scripts.warm_serving_cache --model_path /path/to/VibeVoice-1.5B \\
      --batch_sizes 1 8 --prompt_buckets 1024 4096 --max_new_tokens 4096 --quantize int8
  python -m vibevoice_tpu_torch.scripts.warm_serving_cache --tiny --device cpu

Without `--model_path` it warms a random-weight 1.5B (the engines depend
only on shapes and dtypes); `--tiny` a tiny random fp32 model.  On the CPU
there is no kernel library to build: the kernels' plain versions run there.
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vibevoice_tpu_torch.scripts.warm_serving_cache")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random fp32 model (smoke test)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch_sizes", type=int, nargs="+", default=[1])
    ap.add_argument("--prompt_buckets", type=int, nargs="+", default=None)
    ap.add_argument("--max_new_tokens", type=int, nargs="+", default=[256])
    ap.add_argument("--quantize", default=None, choices=[None, "int8", "int4", "int4f"])
    ap.add_argument("--use_fused_stages", action="store_true",
                    help="warm the large-T stage-kernel path (B>=2 serving)")
    ap.add_argument("--quantize_tokenizer", default=None,
                    choices=[None, "int8", "int4", "int4k"],
                    help="σ-VAE stack quantization (vocoder + semantic encoder)")
    ap.add_argument("--quantize_diffusion", default=None, choices=[None, "int4k"],
                    help="the diffusion head's fused int4 kernel")
    ap.add_argument("--kv_dtype", default="model", choices=["model", "int8"])
    ap.add_argument("--ddpm_steps", type=int, default=5)
    ap.add_argument("--algorithm_type", default="sde-dpmsolver++")
    ap.add_argument("--build_dir", default=None,
                    help="where the kernel libraries go (default: cuda_build.build_dir())")
    args = ap.parse_args(argv)

    import torch
    from ..device import resolve_device
    from ..ops import cuda_build
    from ..pipeline import VibeVoiceTTS
    device = resolve_device(args.device)

    build = None
    if device.type == "cuda":
        if args.build_dir:
            os.environ["VIBEVOICE_TORCH_BUILD_DIR"] = os.path.abspath(args.build_dir)
        present = cuda_build.built()
        seconds, _ = cuda_build.build_all()
        build = dict(seconds=seconds, compiled=len(cuda_build.SOURCES) - len(present),
                     present=len(present), dir=cuda_build.build_dir())
        print(f"kernel libraries built in {seconds:.1f}s: {build['compiled']} compiled, "
              f"{build['present']} already present -> {build['dir']}", flush=True)
    else:
        print("no kernel libraries to build on the CPU: the kernels' plain versions run there",
              flush=True)

    kw = dict(ddpm_steps=args.ddpm_steps, algorithm_type=args.algorithm_type,
              quantize=args.quantize, quantize_tokenizer=args.quantize_tokenizer,
              quantize_diffusion=args.quantize_diffusion,
              use_fused_stages=args.use_fused_stages, kv_dtype=args.kv_dtype, device=device)
    t0 = time.perf_counter()
    if args.model_path:
        tts = VibeVoiceTTS.from_pretrained(args.model_path, **kw)
    elif args.tiny:
        from ..configs import tiny_config
        tts = VibeVoiceTTS.from_random(cfg=tiny_config(vocab_size=320), dtype=torch.float32,
                                       **kw)
    else:
        tts = VibeVoiceTTS.from_random(**kw)
    print(f"model ready in {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    warmed = tts.warm(batch_sizes=args.batch_sizes, prompt_buckets=args.prompt_buckets,
                      max_new_tokens=args.max_new_tokens)
    dt = time.perf_counter() - t0
    for key in warmed:
        print(f"warmed engine (batch={key[0]}, prompt={key[1]}, max_new={key[2]})")
    graphs = sum(e.captures for e in tts._engines.values())
    print(f"{len(warmed)} engines warmed in {dt:.1f}s ({graphs} CUDA graphs captured; "
          f"they live only in this process)")
    return dict(build=build, warmed=warmed, seconds=dt, tts=tts)


if __name__ == "__main__":
    main()
