"""Fused Block1D chain for the small-T sigma-VAE stages: CUDA kernel and
plain versions, over int4 packs and over plain bf16/fp32 packs.

Port of `vibevoice_tpu/ops/fused_blocks.py`.  A tokenizer stage is a chain of
N `Block1D`s (RMSNorm -> causal depthwise conv k=7 -> layer scale -> residual
-> RMSNorm -> FFN with exact GELU -> layer scale -> residual, ref
modular_vibevoice_tokenizer.py:620-684).  At streaming decode a stage sees
T <= 8 frames, and its weights dominate the bytes it moves.

Two TPU kernels, one CUDA source (`csrc/fused_block_chain.cu`, design and
bound described there), one launch per stage call:
  * `fused_block_chain_batched` (int4 packs) replaces
    `vibevoice_tpu/ops/fused_blocks.py:fused_block_chain_batched` (Pallas
    `_kernel_q`); plain version `fused_block_chain_batched_ref`.  One cluster
    launch (`chain_plan`), one grid barrier per block, its workspace cached
    per device, stream and shape (`workspace`).
  * `fused_block_chain_plain` (plain packs) replaces the plain-pack form of
    `vibevoice_tpu/ops/fused_blocks.py:fused_block_chain` (Pallas `_kernel`),
    which the JAX package vmaps over the batch rows; here the batch rides
    inside the launch, so the weights stream once for all rows.  One cluster
    launch (`plain_plan`: the weight slices stream through two rings), one
    grid barrier per block, the same workspace.  Plain version
    `fused_block_chain_plain_ref`.
Each wrapper launches its kernel on CUDA tensors (and counts the launch on
its own `launches`) and runs its plain version on CPU tensors.
`fused_block_chain` is the JAX package's single-row entry and dispatches on
the pack.  The kernel uses the exact `erff` GELU, as the plain versions do;
the TPU kernels use a rational erf (|err| < 1.5e-7).

int4 pack of one stage (`pack_stage_q`; N blocks, dim D, hidden F):
  vecs [N, 8, D] fp32  rows 0 norm_w, 1 mixer_b, 2 gamma, 3 ffn_norm_w,
                       4 ffn_gamma, 5 ffn2_b, 6-7 zero
  mixw [N, 8, D] fp32  rows 0..6 the depthwise taps, row 7 zero
  w1q  [N, D/2, F] int8, sb1 [N, 2, F] fp32 (row 0 ffn1 scale, row 1 ffn1 bias)
  w2q  [N, F/2, D] int8, s2 [N, 1, D] fp32
Plain pack (`pack_stage`), all in the pack dtype: vecs and mixw as above,
w1 [N, D+8, F] (row D the ffn1 bias, rows D+1.. zero), w2 [N, F, D].
Streaming context: ctx [B, N, 6, D], the last 6 mixer inputs of each block.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .int4_matmul import quantize_int4, unpack_int4

CTX = 6  # depthwise kernel 7 -> 6 context rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the cluster kernels (`chain_q_kernel`, int4; `chain_p_kernel`, plain)
CLUSTER = 8           # CTAs per cluster: the portable size
_Q_ROWS = 16          # rows per row group, at most
_Q_THREADS = 256      # threads per CTA
_Q_RP = 8             # rows per register pass
_SMEM_MAX = 227 * 1024
_BOX = 256            # the tensor map's box limit, in rows and in columns
_STAGE_MAX = 49152    # bytes of a plain ring stage, at most (where the slice allows)


def _up(v: int, m: int = 16) -> int:
    return -(-v // m) * m


def chain_smem(d: int, tf: int, bg: int, t: int) -> int:
    """Shared memory of one CTA of the int4 chain kernel (`q_layout` in
    csrc/fused_block_chain.cu) for row groups of bg items of t rows: the W1
    and W2 slices, the FFN input [rows, d] fp32, x of the rank's columns, the
    activations [rows, tf], the up-projection's k splits, the norms' partials
    and exchanges, two of each of the rank's vectors, context rows and ffn1
    scale and bias, the mbarriers, and 128 bytes to align the base."""
    rows, nkl = bg * t, _Q_THREADS // (tf // 4)
    vec = 4 if d % 4 == 0 else 1
    wmax = -(-(d // vec) // CLUSTER) * vec
    return (_up(d // 2 * tf) + _up(tf // 2 * _up(d)) + _up(4 * rows * d) + _up(4 * rows * wmax)
            + _up(4 * rows * tf) + _up(4 * nkl * min(_Q_RP, rows) * tf)
            + _up(4 * (-(-wmax // 32) + 2 * CLUSTER + 2) * rows) + _up(4 * 2 * 14 * wmax)
            + _up(4 * 2 * bg * 6 * wmax) + _up(4 * 4 * tf) + 32 + 128)


class ChainPlan(NamedTuple):
    tf: int        # FFN columns per CTA, a multiple of 16 (or of 4)
    tiles: int     # CTAs that get columns
    clusters: int  # clusters launched
    bg: int        # batch items per row group
    smem: int      # shared memory per CTA, bytes


def chain_plan(b: int, t: int, d: int, f: int, clusters: int) -> ChainPlan:
    """The int4 chain kernel's launch for x [b, t, d] and FFN width f on a
    card that holds `clusters` clusters of CLUSTER CTAs at once: the FFN
    width spread over all their CTAs in columns of whole 16-byte vectors of
    W1 (16 columns; the tensor map's unit) where D and F are multiples of 16,
    else of whole packed words (4 columns), only the clusters that get
    columns launched; row groups of at most 16 rows, as many batch items as
    fit shared memory, balanced."""
    unit = 16 if d % 16 == 0 and f % 16 == 0 else 4
    tf = -(-(-(-f // (clusters * CLUSTER))) // unit) * unit
    tiles = -(-f // tf)
    per = max(1, min(b, _Q_ROWS // t))
    while per > 1 and chain_smem(d, tf, per, t) > _SMEM_MAX:
        per -= 1
    bg = -(-b // -(-b // per))
    smem = chain_smem(d, tf, bg, t)
    if smem > _SMEM_MAX:
        raise ValueError(f"the int4 chain kernel does not fit shared memory at D={d}, F={f}, "
                         f"T={t} ({smem} bytes on {clusters} clusters)")
    return ChainPlan(tf, tiles, -(-tiles // CLUSTER), bg, smem)


def plain_smem(d: int, tf: int, bg: int, t: int, es: int, kb: int, ring: int, r2: int,
               ring2: int) -> int:
    """Shared memory of one CTA of the plain chain kernel (`p_layout` in
    csrc/fused_block_chain.cu) for row groups of bg items of t rows and pack
    elements of `es` bytes: the W1 ring (`ring` boxes of kb rows of tf
    columns), the W2 ring (`ring2` runs of r2 rows of d), the FFN input and
    the activations for the register passes' rows (the rows rounded up to a
    power of two), x of the rank's columns, the up-projection's k splits, the
    norms' partials and exchanges, two of each of the rank's vectors (pack
    dtype), context rows and b1 slice, the mbarriers, and 128 bytes to align
    the base.  The FFN input's and W2's rows are d rounded up to 4 long."""
    rows = bg * t
    big = 1 << (rows - 1).bit_length()
    dp = _up(d, 4)
    vec = 4 if d % 4 == 0 else 1
    wmax = -(-(d // vec) // CLUSTER) * vec
    nkl = _Q_THREADS // (tf // 4)
    return (ring * _up(kb * tf * es, 128) + ring2 * _up(r2 * dp * es, 128) + _up(4 * big * dp)
            + _up(4 * rows * wmax) + _up(4 * big * tf) + _up(4 * nkl * min(_Q_RP, big) * tf)
            + _up(4 * (-(-wmax // 32) + 2 * CLUSTER + 2) * rows) + _up(es * 2 * 14 * wmax)
            + _up(4 * 2 * bg * 6 * wmax) + _up(es * 2 * tf) + 8 * (ring + ring2 + 2) + 128)


class PlainPlan(NamedTuple):
    tf: int        # FFN columns per CTA: whole 16-byte units (or multiples of 4)
    tiles: int     # CTAs that get columns
    clusters: int  # clusters launched
    bg: int        # batch items per row group
    kb: int        # W1 rows per tensor-map box (a ring stage)
    ring: int      # W1 ring stages
    r2: int        # W2 rows per bulk copy (a ring stage)
    ring2: int     # W2 ring stages
    smem: int      # shared memory per CTA, bytes


def plain_plan(b: int, t: int, d: int, f: int, es: int, clusters: int) -> PlainPlan:
    """The plain chain kernel's launch for x [b, t, d], FFN width f and pack
    elements of `es` bytes on a card that holds `clusters` clusters of
    CLUSTER CTAs at once: the FFN width spread over all their CTAs in
    16-byte units of W1 (8 bf16 or 4 fp32 columns; the tensor map's unit)
    where every row of w1 and w2 is whole 16-byte vectors, else in 4-column
    units (the FMAs' width; cp.async copies of the widest of 16, 8, 4 or 1
    bytes the rows allow), only the clusters that get columns launched; row
    groups of at most 16 rows, as many batch items as fit shared memory,
    balanced; W1 in boxes of the most rows (a multiple of 4 that divides d
    rounded up to 4, at most 256) and W2 in runs of the most rows (a multiple
    of 4 that divides tf), each of at most 48 KB (less where two stages a
    ring would not fit); the two rings share what shared memory is left
    evenly, at least 2 and at most two blocks' chunks each.  Any d and f
    plan, unless their rows do not fit shared memory."""
    dp = _up(d, 4)
    unit = 16 // es if (d * es) % 16 == 0 and (f * es) % 16 == 0 else 4
    tf = _up(-(-f // (clusters * CLUSTER)), unit)
    tiles = -(-f // tf)
    kbs = [k for k in range(min(_BOX, dp), 0, -1) if dp % k == 0 and k % 4 == 0]
    r2s = [r for r in range(tf, 0, -1) if tf % r == 0 and r % 4 == 0]
    per = max(1, min(b, _Q_ROWS // t))
    while per > 1 and plain_smem(d, tf, per, t, es, kbs[-1], 2, r2s[-1], 2) > _SMEM_MAX:
        per -= 1
    bg = -(-b // -(-b // per))
    cap = _STAGE_MAX
    while True:  # the largest stages under `cap` of which two a ring fit
        kb = next((k for k in kbs if k * tf * es <= cap), kbs[-1])
        r2 = next((r for r in r2s if r * dp * es <= cap), r2s[-1])
        s1, s2 = _up(kb * tf * es, 128) + 8, _up(r2 * dp * es, 128) + 8  # a stage, its mbarrier
        left = _SMEM_MAX - plain_smem(d, tf, bg, t, es, kb, 0, r2, 0)
        if left >= 2 * (s1 + s2):
            break
        if kb == kbs[-1] and r2 == r2s[-1]:
            raise ValueError(f"the plain chain kernel does not fit shared memory at D={d}, "
                             f"F={f}, T={t} ({left} bytes left for the rings on {clusters} "
                             f"clusters)")
        cap = cap * 3 // 4
    # at most two blocks' chunks a ring
    ring = max(2, min(left // 2 // s1, (left - 2 * s2) // s1, 2 * (dp // kb)))
    ring2 = max(2, min((left - ring * s1) // s2, 2 * (tf // r2)))
    return PlainPlan(tf, tiles, -(-tiles // CLUSTER), bg, kb, ring, r2, ring2,
                     plain_smem(d, tf, bg, t, es, kb, ring, r2, ring2))


def pack_stage(blocks: List[Dict], dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Plain pack of one stage, all in `dtype`: vecs/mixw [N, 8, D] as in the
    int4 pack; w1 [N, D+8, F] with the ffn1 bias in row D (taken through an
    all-ones activation column) and zero rows D+1..; w2 [N, F, D]."""
    if any(isinstance(bp["ffn1"]["w"], dict) for bp in blocks):
        raise ValueError(
            "fused Block1D kernel packs plain weights only — it is mutually "
            "exclusive with quantize_tokenizer")
    n = len(blocks)
    d = blocks[0]["norm_w"].shape[0]
    f = blocks[0]["ffn1"]["w"].shape[1]
    dev = blocks[0]["norm_w"].device
    vecs = torch.zeros((n, 8, d), dtype=dtype, device=dev)
    mixw = torch.zeros((n, 8, d), dtype=dtype, device=dev)
    w1 = torch.zeros((n, d + 8, f), dtype=dtype, device=dev)
    w2 = torch.zeros((n, f, d), dtype=dtype, device=dev)
    for i, bp in enumerate(blocks):
        vecs[i, 0] = bp["norm_w"].to(dtype)
        if bp["mixer"]["b"] is not None:
            vecs[i, 1] = bp["mixer"]["b"].to(dtype)
        vecs[i, 2] = bp["gamma"].to(dtype)
        vecs[i, 3] = bp["ffn_norm_w"].to(dtype)
        vecs[i, 4] = bp["ffn_gamma"].to(dtype)
        if bp["ffn2"]["b"] is not None:
            vecs[i, 5] = bp["ffn2"]["b"].to(dtype)
        mixw[i, :7] = bp["mixer"]["w"][:, 0, :].to(dtype)
        w1[i, :d] = bp["ffn1"]["w"].to(dtype)
        if bp["ffn1"]["b"] is not None:
            w1[i, d] = bp["ffn1"]["b"].to(dtype)
        w2[i] = bp["ffn2"]["w"].to(dtype)
    return {"vecs": vecs, "mixw": mixw, "w1": w1, "w2": w2}


def pack_stage_q(blocks: List[Dict]) -> Dict[str, torch.Tensor]:
    """int4 pack of one stage for the chain kernel: per-output-channel int4
    FFN weights (`ops.int4_matmul.quantize_int4`); ffn1's bias rides in
    `sb1` row 1.  Build it from the original (unquantized) stage weights."""
    if any(isinstance(bp["ffn1"]["w"], dict) for bp in blocks):
        raise ValueError("pack_stage_q needs the original (unquantized) stage weights — "
                         "exclude these stages from quantize_tokenizer")
    n = len(blocks)
    d = blocks[0]["norm_w"].shape[0]
    f = blocks[0]["ffn1"]["w"].shape[1]
    dev = blocks[0]["norm_w"].device
    vecs = torch.zeros((n, 8, d), dtype=torch.float32, device=dev)
    mixw = torch.zeros((n, 8, d), dtype=torch.float32, device=dev)
    w1q = torch.zeros((n, d // 2, f), dtype=torch.int8, device=dev)
    sb1 = torch.zeros((n, 2, f), dtype=torch.float32, device=dev)
    w2q = torch.zeros((n, f // 2, d), dtype=torch.int8, device=dev)
    s2 = torch.zeros((n, 1, d), dtype=torch.float32, device=dev)
    for i, bp in enumerate(blocks):
        vecs[i, 0] = bp["norm_w"].float()
        if bp["mixer"]["b"] is not None:
            vecs[i, 1] = bp["mixer"]["b"].float()
        vecs[i, 2] = bp["gamma"].float()
        vecs[i, 3] = bp["ffn_norm_w"].float()
        vecs[i, 4] = bp["ffn_gamma"].float()
        if bp["ffn2"]["b"] is not None:
            vecs[i, 5] = bp["ffn2"]["b"].float()
        mixw[i, :7] = bp["mixer"]["w"][:, 0, :].float()
        q1 = quantize_int4(bp["ffn1"]["w"])
        w1q[i] = q1["qint4"]
        sb1[i, 0] = q1["scale4"][0]
        if bp["ffn1"]["b"] is not None:
            sb1[i, 1] = bp["ffn1"]["b"].float()
        q2 = quantize_int4(bp["ffn2"]["w"])
        w2q[i] = q2["qint4"]
        s2[i, 0] = q2["scale4"][0]
    return {"vecs": vecs, "mixw": mixw, "w1q": w1q, "sb1": sb1, "w2q": w2q, "s2": s2}


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _chain_ref(packed, x: torch.Tensor, ctx: torch.Tensor, eps: float,
               ffn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in fp32 with the pack's vectors widened; `ffn(i, hn)` is
    block i's FFN up to its output bias."""
    b, t, d = x.shape
    n = packed["vecs"].shape[0]
    h_x = x.float()
    new_ctx = []
    for i in range(n):
        vecs = packed["vecs"][i].float()
        taps = packed["mixw"][i, :7].float()
        c = ctx[:, i].float()                                  # [B, 6, D]
        h = _rms(h_x, eps) * vecs[0]
        full = torch.cat([c, h], dim=1)                        # [B, 6 + T, D]
        new_ctx.append(full[:, t:])
        m = torch.zeros_like(h)
        for k in range(7):
            m = m + full[:, k:k + t] * taps[k]
        y = h_x + vecs[2] * (m + vecs[1])
        hn = _rms(y, eps) * vecs[3]
        h_x = y + vecs[4] * (ffn(i, hn) + vecs[5])
    return h_x.to(x.dtype), torch.stack(new_ctx, dim=1).to(ctx.dtype)


def fused_block_chain_batched_ref(packed, x: torch.Tensor, ctx: torch.Tensor,
                                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch int4 chain, fp32 math as in the TPU kernel: x [B, T, D]
    (T <= 8), ctx [B, N, 6, D] -> (y [B, T, D] in x's dtype, new ctx
    [B, N, 6, D] in ctx's dtype)."""
    def ffn(i, hn):
        a = (hn @ unpack_int4(packed["w1q"][i]).float()) * packed["sb1"][i, 0] \
            + packed["sb1"][i, 1]
        a = F.gelu(a, approximate="none")
        return (a @ unpack_int4(packed["w2q"][i]).float()) * packed["s2"][i, 0]
    return _chain_ref(packed, x, ctx, eps, ffn)


def fused_block_chain_plain_ref(packed, x: torch.Tensor, ctx: torch.Tensor,
                                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch chain over a plain pack, the TPU kernel's math in fp32
    (the pack widened; ffn1's bias is row D of w1): x [B, T, D] (T <= 8), ctx
    [B, N, 6, D] -> (y in x's dtype, new ctx in ctx's dtype)."""
    d = x.shape[-1]

    def ffn(i, hn):
        w1 = packed["w1"][i].float()
        a = F.gelu(hn @ w1[:d] + w1[d], approximate="none")
        return a @ packed["w2"][i].float()
    return _chain_ref(packed, x, ctx, eps, ffn)


def _check(packed, x, ctx, want):
    """Shapes, dtypes, devices and contiguity the kernel takes; `want` maps
    each pack key to its (shape, allowed dtypes)."""
    b, t, d = x.shape
    n = packed["vecs"].shape[0]
    if not 1 <= t <= 8:
        raise ValueError(f"the chain kernel takes 1..8 frames, got {t}")
    for k, (shape, dtypes) in want.items():
        if tuple(packed[k].shape) != shape:
            raise ValueError(f"pack {k} has shape {tuple(packed[k].shape)}, want {shape}")
        if packed[k].dtype not in dtypes:
            raise TypeError(f"pack {k} has dtype {packed[k].dtype}")
    if tuple(ctx.shape) != (b, n, CTX, d):
        raise ValueError(f"ctx {tuple(ctx.shape)} does not fit x {tuple(x.shape)} and {n} blocks")
    if x.dtype not in _DTYPE_CODES or ctx.dtype != x.dtype:
        raise TypeError(f"x and ctx must share float32 or bfloat16, got {x.dtype}/{ctx.dtype}")
    for tns in [x, ctx, *(packed[k] for k in want)]:
        if tns.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on {tns.device}")
        if not tns.is_contiguous():
            raise ValueError("the chain's operands must be contiguous")


_PLANS: Dict[tuple, tuple] = {}


def plan_for(x: torch.Tensor, f: int, wdtype=None):
    """The launch plan for x on its card, made once per device, dtype and
    shape, for the clusters that fit the card at once
    (`cuda_build.fitting_plan`): `chain_plan` for an int4 pack (`wdtype`
    None), `plain_plan` for a plain pack of dtype `wdtype`."""
    b, t, d = x.shape
    key = (str(x.device), x.dtype, wdtype, b, t, d, f)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _library()
        code = _DTYPE_CODES[x.dtype]
        if wdtype is None:
            make, what = (lambda n: chain_plan(b, t, d, f, n)), "the int4 chain kernel"
            ask = lambda smem, out: lib.vv_fused_block_chain_clusters(smem, CLUSTER, code, out)
        else:
            es = torch.empty((), dtype=wdtype).element_size()
            make, what = (lambda n: plain_plan(b, t, d, f, es, n)), "the plain chain kernel"
            ask = lambda smem, out: lib.vv_fused_block_chain_plain_clusters(
                smem, code, _DTYPE_CODES[wdtype], out)

        def fit(smem):
            out = ctypes.c_int(0)
            rc = ask(smem, ctypes.byref(out))
            if rc != 0:
                raise RuntimeError(f"asking the clusters of {what} failed with code {rc}")
            return out.value

        with torch.cuda.device(x.device):
            plan = cuda_build.fitting_plan(x.device, make, fit, what)
        _PLANS[key] = plan
    return plan


_WORKSPACE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device, stream: int, clusters: int, rows: int, d: int):
    """The chain kernels' workspace, made once per device, stream and
    shape: the clusters' fp32 partials [2, clusters, rows, d] (two buffers,
    by block parity) and the grid barrier's int32 counter (0 at first; every
    launch leaves its low bits 0).  Calls on one stream run in order, so they
    share it safely."""
    key = (str(device), stream, clusters, rows, d)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(2 * clusters * rows * d, dtype=torch.float32, device=device),
              torch.zeros(1, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def fused_block_chain_batched(packed, x: torch.Tensor, ctx: torch.Tensor,
                              eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4-pack chain for a batch: x [B, T, D] (T <= 8), ctx [B, N, 6, D] ->
    (y [B, T, D], new_ctx [B, N, 6, D]).  CUDA tensors launch the kernel (one
    cluster launch, counted once); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_block_chain_batched_ref(packed, x, ctx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_chain_batched runs on cuda or cpu, not {x.device}")
    b, t, d = x.shape
    n, _, pd = packed["vecs"].shape
    f = packed["w1q"].shape[2]
    if d % 2 or f % 2 or pd != d:
        raise ValueError(f"the chain kernel takes even D and F matching the pack; "
                         f"got D={d}, F={f}, pack D={pd}")
    fp32, i8 = (torch.float32,), (torch.int8,)
    _check(packed, x, ctx, {"vecs": ((n, 8, d), fp32), "mixw": ((n, 8, d), fp32),
                            "w1q": ((n, d // 2, f), i8), "sb1": ((n, 2, f), fp32),
                            "w2q": ((n, f // 2, d), i8), "s2": ((n, 1, d), fp32)})
    keys = ("vecs", "mixw", "w1q", "sb1", "w2q", "s2")
    if any(packed[k].data_ptr() % 16 for k in keys):
        raise ValueError("the chain kernel's pack tensors must be 16-byte aligned")
    plan = plan_for(x, f)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, bar = workspace(x.device, stream, plan.clusters, plan.bg * t, d)
    y = torch.empty_like(x)
    new_ctx = torch.empty_like(ctx)
    with torch.cuda.device(x.device):
        rc = _library().vv_fused_block_chain(
            x.data_ptr(), ctx.data_ptr(), *(packed[k].data_ptr() for k in keys), y.data_ptr(),
            new_ctx.data_ptr(), part.data_ptr(), bar.data_ptr(), b, t, d, f, n, plan.bg,
            plan.tf, plan.clusters, CLUSTER, float(eps), _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"vv_fused_block_chain kernel failed with code {rc}")
    fused_block_chain_batched.launches += 1
    return y, new_ctx


fused_block_chain_batched.launches = 0


def fused_block_chain_plain(packed, x: torch.Tensor, ctx: torch.Tensor,
                            eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-pack (bf16/fp32) chain for a batch: x [B, T, D] (T <= 8), ctx
    [B, N, 6, D] -> (y [B, T, D], new_ctx [B, N, 6, D]).  CUDA tensors launch
    the kernel (one cluster launch for all rows, counted once); CPU tensors
    take `fused_block_chain_plain_ref`."""
    if x.device.type == "cpu":
        return fused_block_chain_plain_ref(packed, x, ctx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_chain_plain runs on cuda or cpu, not {x.device}")
    b, t, d = x.shape
    n = packed["vecs"].shape[0]
    f = packed["w1"].shape[2]
    wdt = packed["w1"].dtype
    if wdt not in _DTYPE_CODES:
        raise TypeError(f"a plain pack holds float32 or bfloat16, got {wdt}")
    _check(packed, x, ctx, {"vecs": ((n, 8, d), (wdt,)), "mixw": ((n, 8, d), (wdt,)),
                            "w1": ((n, d + 8, f), (wdt,)), "w2": ((n, f, d), (wdt,))})
    plan = plan_for(x, f, wdt)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, bar = workspace(x.device, stream, plan.clusters, plan.bg * t, d)
    y = torch.empty_like(x)
    new_ctx = torch.empty_like(ctx)
    with torch.cuda.device(x.device):
        rc = _library().vv_fused_block_chain_plain(
            x.data_ptr(), ctx.data_ptr(), *(packed[k].data_ptr() for k in ("vecs", "mixw", "w1",
                                                                           "w2")),
            y.data_ptr(), new_ctx.data_ptr(), part.data_ptr(), bar.data_ptr(), b, t, d, f, n,
            plan.bg, plan.tf, plan.clusters, plan.kb, plan.ring, plan.r2, plan.ring2, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[wdt], stream)
    if rc != 0:
        raise RuntimeError(f"vv_fused_block_chain_plain kernel failed with code {rc}")
    fused_block_chain_plain.launches += 1
    return y, new_ctx


fused_block_chain_plain.launches = 0


def fused_block_chain(packed, x: torch.Tensor, ctx: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain for ONE batch row (the JAX package's entry): x [T, D], ctx
    [N, 6, D] -> (y [T, D], new_ctx [N, 6, D]); an int4 pack goes through
    `fused_block_chain_batched`, a plain one through `fused_block_chain_plain`."""
    run = fused_block_chain_batched if "w1q" in packed else fused_block_chain_plain
    y, new_ctx = run(packed, x[None], ctx[None], eps=eps)
    return y[0], new_ctx[0]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_block_chain")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, args in ((lib.vv_fused_block_chain, [p] * 12 + [i] * 9 + [fl, i, p]),
                     (lib.vv_fused_block_chain_plain, [p] * 10 + [i] * 12 + [fl, i, i, p]),
                     (lib.vv_fused_block_chain_clusters,
                      [ctypes.c_longlong, i, i, ctypes.POINTER(i)]),
                     (lib.vv_fused_block_chain_plain_clusters,
                      [ctypes.c_longlong, i, i, ctypes.POINTER(i)])):
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def pack_bytes(packed) -> int:
    """Bytes of a stage pack (what one chain call streams, weights and vectors)."""
    return sum(t.numel() * t.element_size() for t in packed.values())


__all__ = ["CTX", "chain_plan", "chain_smem", "plain_plan", "plain_smem", "plan_for",
           "workspace", "pack_stage", "pack_stage_q", "fused_block_chain",
           "fused_block_chain_batched", "fused_block_chain_batched_ref",
           "fused_block_chain_plain", "fused_block_chain_plain_ref", "pack_bytes"]
