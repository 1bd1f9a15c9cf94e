#!/usr/bin/env python3
"""Where the time of one fused-stage or small-T chain launch goes, phase by
phase, on one NVIDIA GPU.

    python3 scripts/torch_stage_phases.py [stage] [chain] [chain-fine] [plain] [head] [--other DIR]

Builds an instrumented copy of `vibevoice_tpu_torch/csrc/fused_stage.cu` into
the build directory: CTA 0 reads the `%globaltimer` at the kernel's start
and after each grid barrier (and at its end), so the gap between two stamps
is the slowest CTA's time in that phase plus the barrier (for a phase that
ends without a barrier, CTA 0's own time).  The shipped source
is not touched; the copy runs in place of it for this process only.  For a
few stage shapes of the 1.5B model (random bf16 weights from a seed) it
prints one JSON line: the launch's device time (`chip_smoke.cuda_ms`), the
grid size and the phase times in microseconds with their names; a row-lane
shape, then the stage kernel on the same rows (the pack without its row-lane
entry).  The stage
kernel (`cluster_kernel`, also the row-lane form's) has one phase per block
([conv,] block 0 .. N-1).

`chain` does the same for the int4 Block1D chain
(`csrc/fused_block_chain.cu`, `fused_block_chain_batched`) at the 1.5B
model's two small-T stage shapes (D=2048, 8 blocks, T=1; D=1024, 3 blocks,
T=8) at B=1 and at B=4, stamping after each of the kernel's grid barriers:
the cooperative `chain_kernel` of earlier checkouts syncs the grid twice per
block (mixer and FFN tiles / partial sums), the cluster kernel once (one
phase per block and row group).  With `--other`, the chain of that checkout
(for example the parent commit, unpacked with `git archive`) is stamped and
timed instead, through its own wrapper, into its own build directory.
`chain-fine` stamps this checkout's cluster kernel six times per block,
each stamp after a barrier of the CTA's threads: after the mixer (with the
step's small copies), the up-projection, the down-projection, the cluster's
partial (with the next W2's request), the grid barrier and the sums of the
partials.  `plain` stamps the plain-pack chain (`chain_p_kernel`,
`fused_block_chain_plain`, bf16 packs) six times per block in the same
places (the up- and down-projection each with their ring's waits and
refills) at the two small-T stage shapes with B=1 and at D=1024 with B=2.
`head` stamps the int4 diffusion-head kernel (`csrc/fused_head.cu`)
seven times per layer, after: the norm and its two cluster exchanges (with
the layer's small copies), the up-projection, the down-projection, the
cluster's partial, the grid barrier, the sums of the partials, and the final
layer (cluster 0, after the last layer; a stamp alone elsewhere), at the
1.5B head with N=2 and N=8 and the 7B head with N=2.  `stage` and `chain` by
default; last, the card's name and power limit.
"""
import ctypes
import json
import os
import re
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
#define FSTAMP { __syncthreads(); STAMP }
extern "C" int vv_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
"""

# (name, B, stage T, D, folded conv (kind, s, k, cin), row-lane R)
SHAPES = [("decoder 3", 1, 200, 256, ("up", 5, 10, 512), None),
          ("decoder 6", 1, 3200, 32, ("up", 2, 4, 64), None),
          ("encoder 0", 1, 3200, 32, ("down", 1, 7, 1), None),
          ("encoder 3", 1, 200, 256, ("down", 4, 8, 128), None),
          ("decoder 6 row-lane", 2, 3200, 32, None, 2),
          ("decoder 5 row-lane", 2, 1600, 64, None, 2),
          ("decoder 6 row-lane", 4, 3200, 32, None, 4)]


# the int4 chain kernel of a checkout, as (kernel, end, start, barrier,
# barriers per block): this tree's cluster kernel, then the cooperative one
CHAIN_KERNELS = [
    ("__global__ void __launch_bounds__(NT, 1)\n    chain_q_kernel",
     "  cl.sync();  // no peer reads this CTA's shared memory after it exits\n}",
     "extern __shared__ __align__(128) unsigned char smem_raw[];", "grid_barrier(a.bar);", 1),
    ("__global__ void __launch_bounds__(THREADS) chain_kernel",
     "      grid.sync();\n    }\n  }\n}", "extern __shared__ float sm[];", "grid.sync();", 2),
]
# the statements of the cluster kernel's step after which `chain-fine`
# stamps, and the phases they end
FINE_MARKS = [("             nrm, xch, rs1, rs2, D);", "mixer"),
              ("    if (has_tile) up_proj(a, f0, w1s, hb, rs2, rows, rp, sb + par * 2 * a.TF, red, as);",
               "up"),
              ("    if (has_tile) down_proj(a, w2s, as, rows, hb);", "down"),
              ("      cluster_partial<1>(a, cl, step, hb, D, rows, rows_max);", "partial"),
              ("    grid_barrier(a.bar);  // the block's only grid-wide barrier", "barrier"),
              ("      next_x<T, int8_t, 1>(a, cl, step, v, wmax, xs, rows, rows_max, base, "
               "nb == NB - 1);", "next_x")]
# (name, B, T, D, blocks): the 1.5B small-T stages, and B=4
CHAIN_SHAPES = [("decoder 0 / encoder 6", 1, 1, 2048, 8), ("decoder 1 / encoder 5", 1, 8, 1024, 3),
                ("decoder 1, B=4", 4, 8, 1024, 3)]


def _stamped(src: str, kernel: str, end: str, start: str, barrier: str,
             what: str = "fused_stage.cu") -> str:
    """`src` with stamps in the body of `kernel` (which runs up to `end`): at
    `start`, after every `barrier` and after `end`'s last statement."""
    for marker in (kernel, end, start, barrier):
        if marker not in src:
            raise RuntimeError(f"{what} no longer has {marker!r}: update this script")
    a = src.index(kernel)
    b = src.index(end, a) + len(end)
    body = (src[a:b].replace(start, start + "\n  int ns = 0;\n  STAMP")
            .replace(barrier, barrier + "\n    STAMP"))
    body = body[:-1] + "  __syncthreads();\n  STAMP\n}"
    return src[:a] + body + src[b:]


def _with_stamps(src: str, csrc: str, what: str) -> str:
    """`src` with its csrc/ headers included by absolute path (the copy is
    built elsewhere) and the stamp helpers after the last of them."""
    includes = re.findall(r'#include "(\w+\.cuh)"\n', src)
    if "int4_common.cuh" not in includes:
        raise RuntimeError(f"{what} no longer includes int4_common.cuh: update this script")
    for name in includes:
        line = f'#include "{name}"\n'
        src = src.replace(line, f'#include "{os.path.join(csrc, name)}"\n'
                          + (STAMPS if name == includes[-1] else ""))
    return src


def _fine_stamped(src: str, kernel: str, end: str, start: str, marks, what: str) -> str:
    """`src` with a stamp at `start` of `kernel`'s body (which runs up to
    `end`) and one after each of `marks`, each behind a barrier of the CTA's
    threads."""
    a = src.index(kernel)
    b = src.index(end, a)
    body = src[a:b].replace(start, start + "\n  int ns = 0;\n  STAMP")
    for mark, _ in marks:
        if mark not in body:
            raise RuntimeError(f"{what} no longer has {mark!r}: update this script")
        body = body.replace(mark, mark + "\n    FSTAMP")
    return src[:a] + body + src[b:]


def instrumented_source() -> str:
    from vibevoice_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_stage.cu")) as f:
        src = f.read()
    src = _stamped(src, "__global__ void __launch_bounds__(THREADS) cluster_kernel",
                   "reinterpret_cast<float*>(smc));\n}",
                   "extern __shared__ __align__(16) unsigned char smc[];",
                   "grid_barrier(p.bar);")
    return _with_stamps(src, cuda_build.CSRC_DIR, "fused_stage.cu")


def instrumented_chain(csrc: str, fine: bool = False):
    """(`fused_block_chain.cu` of the checkout whose csrc/ is `csrc`, stamped
    in its int4 chain kernel; that kernel's stamps per block)."""
    with open(os.path.join(csrc, "fused_block_chain.cu")) as f:
        src = f.read()
    if fine:
        src = _fine_stamped(src, *CHAIN_KERNELS[0][:3], FINE_MARKS, "fused_block_chain.cu")
        return _with_stamps(src, csrc, "fused_block_chain.cu"), len(FINE_MARKS)
    for kernel, end, start, barrier, per_block in CHAIN_KERNELS:
        if kernel in src:
            src = _stamped(src, kernel, end, start, barrier, "fused_block_chain.cu")
            return _with_stamps(src, csrc, "fused_block_chain.cu"), per_block
    raise RuntimeError("fused_block_chain.cu has no chain kernel this script knows")


def _stamped_library(cuda_build, name: str, src: str, loader):
    """Point `cuda_build` at the stamped copy `src` of kernel `name` and load
    it with `loader` (the wrapper module's own `_library`), in place of a
    library of that name this process loaded before."""
    cuda_build._LIBS.pop(name, None)
    os.makedirs(cuda_build.build_dir(), exist_ok=True)
    path = os.path.join(cuda_build.build_dir(), f"{name}_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    cuda_build.SOURCES[name] = os.path.relpath(path, cuda_build.CSRC_DIR)
    lib = loader()
    lib.vv_stamps.argtypes = [ctypes.c_void_p]
    return lib


def read_stamps(lib, n: int):
    """(the first n + 1 stamps' gaps in µs, the grid size) of the last launch."""
    torch.cuda.synchronize()
    stamps = (ctypes.c_ulonglong * 64)()
    rc = lib.vv_stamps(ctypes.addressof(stamps))
    if rc:
        raise RuntimeError(f"reading the stamps failed with {rc}")
    ts = [stamps[i] for i in range(n + 1)]
    return [(b - a) / 1e3 for a, b in zip(ts, ts[1:])], stamps[63]


def phase_names(conv, n_blocks=3):
    return (["conv"] if conv else []) + [f"block {i}" for i in range(n_blocks)]


def stage_phases(dev):
    import chip_smoke as cs
    from vibevoice_tpu_torch.ops import cuda_build, fused_stage as fs
    lib = _stamped_library(cuda_build, "fused_stage", instrumented_source(), fs._library)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for name, b, t, d, conv, r in SHAPES:
        pack = cs.random_stage_pack(d, conv, False, r, gen, dev)
        xs, ctx, states = cs.stage_inputs(pack, b, t, gen, dev)
        # a row-lane shape, then the stage kernel on the same rows
        for pk in [pack] + ([{k: v for k, v in pack.items() if k != "rowlane"}] if r else []):
            ms = cs.cuda_ms(lambda i: fs.fused_stage_chain(pk, xs[0], ctx, **states), 20)
            fs.fused_stage_chain(pk, xs[0], ctx, **states)  # the launch whose stamps are read
            names = phase_names(conv)
            us, grid = read_stamps(lib, len(names))
            print(json.dumps({"stage": name, "B": b, "T": t, "D": d, "conv": conv,
                              "rows": r if pk is pack else None, "launch_us": 1e3 * ms,
                              "grid": grid, "phases": names, "phase_us": us}), flush=True)


def chain_phases(dev, other, fine=False):
    """The int4 chain's phases at CHAIN_SHAPES, of this checkout or of the
    checkout at `other` (or, `fine`, this checkout's within each block);
    each launch checked against this checkout's plain version first."""
    import chip_smoke as cs
    from vibevoice_tpu_torch.ops import cuda_build, fused_blocks as fb
    if other:
        from torch_kernel_compare import load_other
        ofb = load_other(other, ["fused_blocks"])["fused_blocks"]
        ocb = sys.modules[ofb.__name__.rsplit(".", 1)[0] + ".cuda_build"]
    else:
        ofb, ocb = fb, cuda_build
    src, per_block = instrumented_chain(ocb.CSRC_DIR, fine)
    lib = _stamped_library(ocb, "fused_block_chain", src, ofb._library)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, b, t, d, nblk in CHAIN_SHAPES:
        packs = [fb.pack_stage_q(cs.random_stage(d, nblk, gen, dev))
                 for _ in range(cs.copies_for(nblk * d * 4 * d))]
        x, ctx = cs.chain_inputs(packs[0], b, t, gen, dev)
        got = ofb.fused_block_chain_batched(packs[0], x, ctx)
        want = fb.fused_block_chain_batched_ref(packs[0], x, ctx)
        err = max(cs.agree("fused_block_chain_batched", g, w)[0] for g, w in zip(got, want))
        n = len(packs)
        ms = cs.cuda_ms(lambda i: ofb.fused_block_chain_batched(packs[i % n], x, ctx), 2 * n)
        ofb.fused_block_chain_batched(packs[1 % n], x, ctx)  # the launch whose stamps are read
        groups = -(-b // ofb_items(ofb, x, 4 * d))
        phases = ([ph for _, ph in FINE_MARKS] if fine
                  else ("mixer+ffn", "sum") if per_block > 1 else ("",))
        names = [f"group {g} block {i} {ph}".rstrip() for g in range(groups) for i in range(nblk)
                 for ph in phases]
        us, grid = read_stamps(lib, len(names) + (0 if fine else 1))
        print(json.dumps({"chain": name, "checkout": other or "this", "B": b, "T": t, "D": d,
                          "F": 4 * d, "blocks": nblk, "max_abs_err": err, "launch_us": 1e3 * ms,
                          "grid": grid, "barriers_per_block": per_block,
                          "phases": names + ([] if fine else ["end"]), "phase_us": us}),
              flush=True)
        del packs


# the plain chain kernel (`chain_p_kernel`): its body and the statements of a
# block after which `plain` stamps, and the phases they end
PLAIN_KERNEL = ("__global__ void __launch_bounds__(NT, 1)\n    chain_p_kernel",
                "  cl.sync();  // no peer reads this CTA's shared memory after it exits\n}",
                "extern __shared__ __align__(128) unsigned char smem_raw[];")
PLAIN_MARKS = [("                nrm, xch, rs1, rs2, Dp);", "mixer"),
               ("                         sb + par * a.TF, rows, red, as);", "up"),
               ("        down_proj_p<NR, W>(a, step, steps, f0, w2r, L.w2_stage, mb2, as, hb);",
                "down"),
               ("      cluster_partial<1>(a, cl, step, hb, Dp, rows, rows_max);", "partial"),
               ("    grid_barrier(a.bar);  // the block's only grid-wide barrier", "barrier"),
               ("      next_x<T, W, 1>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);",
                "next_x")]
# (name, B, T, D, blocks): the 1.5B small-T stages, and B=2
PLAIN_SHAPES = [("decoder 0 / encoder 6", 1, 1, 2048, 8), ("decoder 1 / encoder 5", 1, 8, 1024, 3),
                ("decoder 1, B=2", 2, 8, 1024, 3)]


def plain_phases(dev):
    """The plain-pack chain's phases per block at PLAIN_SHAPES (bf16 packs),
    each launch checked against the plain version first."""
    import chip_smoke as cs
    from vibevoice_tpu_torch.ops import cuda_build, fused_blocks as fb
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_block_chain.cu")) as f:
        src = _fine_stamped(f.read(), *PLAIN_KERNEL, PLAIN_MARKS, "fused_block_chain.cu")
    lib = _stamped_library(cuda_build, "fused_block_chain",
                           _with_stamps(src, cuda_build.CSRC_DIR, "fused_block_chain.cu"),
                           fb._library)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    for name, b, t, d, nblk in PLAIN_SHAPES:
        packs = [fb.pack_stage(cs.random_stage(d, nblk, gen, dev), dtype=torch.bfloat16)
                 for _ in range(cs.copies_for(2 * nblk * d * 4 * d * 2))]
        x, ctx = cs.chain_inputs(packs[0], b, t, gen, dev)
        got = fb.fused_block_chain_plain(packs[0], x, ctx)
        want = fb.fused_block_chain_plain_ref(packs[0], x, ctx)
        err = max(cs.agree("fused_block_chain", g, w)[0] for g, w in zip(got, want))
        n = len(packs)
        ms = cs.cuda_ms(lambda i: fb.fused_block_chain_plain(packs[i % n], x, ctx), 2 * n)
        fb.fused_block_chain_plain(packs[1 % n], x, ctx)  # the launch whose stamps are read
        plan = fb.plan_for(x, 4 * d, torch.bfloat16)
        names = [f"group {g} block {i} {ph}" for g in range(-(-b // plan.bg)) for i in range(nblk)
                 for _, ph in PLAIN_MARKS]
        us, grid = read_stamps(lib, len(names))
        print(json.dumps({"plain_chain": name, "B": b, "T": t, "D": d, "F": 4 * d,
                          "blocks": nblk, "max_abs_err": err, "launch_us": 1e3 * ms,
                          "grid": grid, "plan": plan._asdict(), "phases": names,
                          "phase_us": us}), flush=True)
        del packs


# the head kernel (`head_q_kernel`): its body and the statements of a layer
# after which `head` stamps, and the phases they end
HEAD_KERNEL = ("__global__ void __launch_bounds__(NT, 1)\n    head_q_kernel",
               "  cl.sync();  // no peer reads this CTA's shared memory after it exits\n}",
               "extern __shared__ __align__(128) unsigned char smem_raw[];")
HEAD_MARKS = [("    norm_h<T>(a, cl, nr, c0, w, wmax, xs, md, fv, nrm, xch, rs, hb);", "norm"),
              ("                                    sgv, suv, red, as);\n      });", "up"),
              ("mb_w2, as, hb);\n      });", "down"),
              ("    cluster_partial(a, cl, step, hb, nr, c0, w);", "partial"),
              ("    grid_barrier(a.bar);  // the layer's only grid-wide barrier", "barrier"),
              ("    if (l < L - 1 || cid == 0) next_x<T>(a, step, nr, c0, w, wmax, md, fv + wmax, xs);",
               "sums"),
              ("      final_layer<T>(a, cl, n0, nr, w, c0, wmax, xs, sh, nrm, red, hb);", "final")]


def head_phases(dev):
    """The int4 head solver step's phases per layer at the compare script's
    head cases (4 layers, latent 64, bf16), each launch checked against the
    plain version first."""
    import chip_smoke as cs
    from torch_kernel_compare import HEAD_CASES
    from vibevoice_tpu_torch.ops import cuda_build, fused_head as fh
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_head.cu")) as f:
        src = _fine_stamped(f.read(), *HEAD_KERNEL, HEAD_MARKS, "fused_head.cu")
    lib = _stamped_library(cuda_build, "fused_head",
                           _with_stamps(src, cuda_build.CSRC_DIR, "fused_head.cu"), fh._library)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for n, h, f in HEAD_CASES:
        packs = [fh.pack_head_solver_q(cs.random_head(h, f, gen, dev))
                 for _ in range(cs.copies_for(6 * h * f))]
        x, mods, fmod, fl = cs.head_inputs(packs[0], n, 64, gen, dev)
        err = cs.agree("fused_head_solver_step", fh.fused_head_solver_step(packs[0], x, mods, fmod,
                                                                           fl, 1e-5),
                       fh.fused_head_solver_step_ref(packs[0], x, mods, fmod, fl, 1e-5))[0]
        k = len(packs)
        ms = cs.cuda_ms(lambda i: fh.fused_head_solver_step(packs[i % k], x, mods, fmod, fl, 1e-5),
                        2 * k)
        fh.fused_head_solver_step(packs[1 % k], x, mods, fmod, fl, 1e-5)  # the stamped launch
        plan = fh.plan_for(x, f, 64)
        names = [f"group {g} layer {i} {ph}" for g in range(-(-n // plan.rows)) for i in range(4)
                 for _, ph in HEAD_MARKS]
        us, grid = read_stamps(lib, len(names))
        print(json.dumps({"head": f"N={n} H={h} F={f}", "layers": 4, "max_abs_err": err,
                          "launch_us": 1e3 * ms, "grid": grid, "plan": plan._asdict(),
                          "phases": names, "phase_us": us}), flush=True)
        del packs


def ofb_items(ofb, x, f):
    """Batch items per row group of a checkout's int4 chain at x [B, T, D]."""
    if hasattr(ofb, "plan_for"):
        return ofb.plan_for(x, f).bg
    return ofb.row_group(*x.shape)


def main() -> int:
    args = sys.argv[1:]
    other = None
    if "--other" in args:
        i = args.index("--other")
        other = args[i + 1]
        del args[i:i + 2]
    if not set(args) <= {"stage", "chain", "chain-fine", "plain", "head"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_stage_phases: no CUDA device", file=sys.stderr)
        return 2
    from vibevoice_tpu_torch.engine.generate import resolve_device
    dev = resolve_device("cuda")
    if "stage" in (args or ["stage"]) and other is None:
        stage_phases(dev)
    if "chain" in (args or ["chain"]):
        chain_phases(dev, other)
    if "chain-fine" in args:
        chain_phases(dev, None, fine=True)
    if "plain" in args:
        plain_phases(dev)
    if "head" in args:
        head_phases(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
