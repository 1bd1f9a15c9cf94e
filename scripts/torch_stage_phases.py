#!/usr/bin/env python3
"""Where the time of one fused-stage launch goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/torch_stage_phases.py

Builds an instrumented copy of `vibevoice_tpu_torch/csrc/fused_stage.cu` into
the build directory: CTA 0 reads the `%globaltimer` at the kernel's start
and after each grid barrier (and at its end), so the gap between two stamps
is the slowest CTA's time in that phase plus the barrier (for a phase that
ends without a barrier, CTA 0's own time).  The shipped source
is not touched; the copy runs in place of it for this process only.  For a
few stage shapes of the 1.5B model (random bf16 weights from a seed) it
prints one JSON line: the launch's device time (`chip_smoke.cuda_ms`), the
grid size and the phase times in microseconds with their names.  The stage
kernel (`cluster_kernel`) has one phase per block ([conv,] block 0 .. N-1),
the row-lane kernel (`stage_kernel`) per block mixer / FFN / partial sums,
then the output.  Last, the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAMPS = """
__device__ unsigned long long g_stamps[64];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP if (blockIdx.x == 0 && threadIdx.x == 0) { g_stamps[ns++] = global_ns(); g_stamps[63] = gridDim.x; }
extern "C" int vv_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
"""

# (name, B, stage T, D, folded conv (kind, s, k, cin), row-lane R)
SHAPES = [("decoder 3", 1, 200, 256, ("up", 5, 10, 512), None),
          ("decoder 6", 1, 3200, 32, ("up", 2, 4, 64), None),
          ("encoder 0", 1, 3200, 32, ("down", 1, 7, 1), None),
          ("encoder 3", 1, 200, 256, ("down", 4, 8, 128), None),
          ("decoder 6 row-lane", 4, 3200, 32, None, 4)]


def _stamped(src: str, kernel: str, end: str, start: str, barrier: str) -> str:
    """`src` with stamps in the body of `kernel` (which runs up to `end`): at
    `start`, after every `barrier` and after `end`'s last statement."""
    for marker in (kernel, end, start, barrier):
        if marker not in src:
            raise RuntimeError(f"fused_stage.cu no longer has {marker!r}: update this script")
    a = src.index(kernel)
    b = src.index(end, a) + len(end)
    body = (src[a:b].replace(start, start + "\n  int ns = 0;\n  STAMP")
            .replace(barrier, barrier + "\n    STAMP"))
    body = body[:-1] + "  __syncthreads();\n  STAMP\n}"
    return src[:a] + body + src[b:]


def instrumented_source() -> str:
    from vibevoice_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_stage.cu")) as f:
        src = f.read()
    header = '#include "int4_common.cuh"'
    if header not in src:
        raise RuntimeError(f"fused_stage.cu no longer has {header!r}: update this script")
    src = _stamped(src, "__global__ void __launch_bounds__(THREADS) stage_kernel",
                   "phase_out<T>(p, p.xb, sm);\n}", "extern __shared__ float sm[];",
                   "grid.sync();")
    src = _stamped(src, "__global__ void __launch_bounds__(THREADS) cluster_kernel",
                   "reinterpret_cast<float*>(smc));\n}",
                   "extern __shared__ __align__(16) unsigned char smc[];",
                   "grid_barrier(p.bar);")
    return src.replace(header, f'#include "{os.path.join(cuda_build.CSRC_DIR, "int4_common.cuh")}"'
                       + STAMPS)


def phase_names(conv, rowlane, n_blocks=3):
    if rowlane:
        return [f"{ph} {i}" for i in range(n_blocks) for ph in ("mixer", "ffn", "sum")] + ["out"]
    return (["conv"] if conv else []) + [f"block {i}" for i in range(n_blocks)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stage_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vibevoice_tpu_torch.engine.generate import resolve_device
    from vibevoice_tpu_torch.ops import cuda_build, fused_stage as fs
    os.makedirs(cuda_build.build_dir(), exist_ok=True)
    path = os.path.join(cuda_build.build_dir(), "fused_stage_stamped.cu")
    with open(path, "w") as f:
        f.write(instrumented_source())
    cuda_build.SOURCES["fused_stage"] = os.path.relpath(path, cuda_build.CSRC_DIR)
    lib = fs._library()
    lib.vv_stamps.argtypes = [ctypes.c_void_p]
    stamps = (ctypes.c_ulonglong * 64)()

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for name, b, t, d, conv, r in SHAPES:
        pack = cs.random_stage_pack(d, conv, False, r, gen, dev)
        xs, ctx, states = cs.stage_inputs(pack, b, t, gen, dev)
        ms = cs.cuda_ms(lambda i: fs.fused_stage_chain(pack, xs[0], ctx, **states), 20)
        fs.fused_stage_chain(pack, xs[0], ctx, **states)  # the launch whose stamps are read
        torch.cuda.synchronize()
        rc = lib.vv_stamps(ctypes.addressof(stamps))
        if rc:
            raise RuntimeError(f"reading the stamps failed with {rc}")
        names = phase_names(conv, cs.uses_rowlane(pack, b))
        ts = [stamps[i] for i in range(len(names) + 1)]
        print(json.dumps({"stage": name, "B": b, "T": t, "D": d, "conv": conv, "rows": r,
                          "launch_us": 1e3 * ms, "grid": stamps[63], "phases": names,
                          "phase_us": [(b_ - a_) / 1e3 for a_, b_ in zip(ts, ts[1:])]}),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
