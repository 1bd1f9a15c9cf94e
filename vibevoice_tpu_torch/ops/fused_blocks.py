"""Fused int4 Block1D chain for the small-T sigma-VAE stages: CUDA kernel and
plain version.

Port of `vibevoice_tpu/ops/fused_blocks.py` (int4 packs).  A tokenizer stage
is a chain of N `Block1D`s (RMSNorm -> causal depthwise conv k=7 -> layer
scale -> residual -> RMSNorm -> int4 FFN with exact GELU -> layer scale ->
residual, ref modular_vibevoice_tokenizer.py:620-684).  At streaming decode a
stage sees T <= 8 frames, and its weights dominate the bytes it moves.

`fused_block_chain_batched` replaces the TPU kernel
`vibevoice_tpu/ops/fused_blocks.py:fused_block_chain_batched` (Pallas
`_kernel_q`).  On CUDA tensors it runs the whole stage as ONE cooperative
launch of `csrc/fused_block_chain.cu` (design and bound are described
there); on CPU tensors it runs `fused_block_chain_batched_ref`, the plain
version with the same signature, which is also the kernel's oracle.  The
kernel uses the exact `erff` GELU, as the plain version does; the TPU kernel
uses a rational erf (|err| < 1.5e-7).

int4 pack of one stage (`pack_stage_q`; N blocks, dim D, hidden F):
  vecs [N, 8, D] fp32  rows 0 norm_w, 1 mixer_b, 2 gamma, 3 ffn_norm_w,
                       4 ffn_gamma, 5 ffn2_b, 6-7 zero
  mixw [N, 8, D] fp32  rows 0..6 the depthwise taps, row 7 zero
  w1q  [N, D/2, F] int8, sb1 [N, 2, F] fp32 (row 0 ffn1 scale, row 1 ffn1 bias)
  w2q  [N, F/2, D] int8, s2 [N, 1, D] fp32
Streaming context: ctx [B, N, 6, D], the last 6 mixer inputs of each block.

The bf16/fp32 pack (`pack_stage`; the large-T stage kernel of
`ops/fused_stage.py` runs on it) is ported; its single-row T <= 8 kernel
(`fused_block_chain` with such a pack, TPU kernel #6) is not yet (ROADMAP B6)
and raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .int4_matmul import quantize_int4, unpack_int4

CTX = 6  # depthwise kernel 7 -> 6 context rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_FLOATS = 40960  # activation rows kept in shared memory per row group (fp32)
_MAX_TILE = 64        # FFN columns per tile


def ffn_tile(f: int, n_ctas: int) -> Tuple[int, int]:
    """(tile width, tiles) of an FFN of width f: about one tile per CTA of
    the cooperative grid, a multiple of 4 columns (one packed word per
    thread), at most 64."""
    tf = -(-f // max(1, n_ctas))
    tf = max(4, min(_MAX_TILE, -(-tf // 4) * 4))
    return tf, -(-f // tf)


def row_group(batch: int, rows_per_item: int, d: int) -> int:
    """Batch items per row group: as many as keep [rows, d] fp32 activations
    inside the kernel's shared-memory budget."""
    if rows_per_item * d > _ROWS_FLOATS:
        raise ValueError(f"{rows_per_item} rows of width {d} exceed the kernel's "
                         f"shared-memory budget")
    return max(1, min(batch, _ROWS_FLOATS // (rows_per_item * d)))


def refuse_plain_chain():
    """A plain (bf16/fp32) pack met the T <= 8 chain: its single-row kernel
    is not ported yet."""
    raise NotImplementedError(
        "the bf16/fp32 fused Block1D chain (TPU kernel #6, use_fused_vocoder with "
        "plain packs) is not ported yet (ROADMAP B6)")


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


def fused_block_chain_batched_ref(packed, x: torch.Tensor, ctx: torch.Tensor,
                                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch int4 chain, fp32 math as in the TPU kernel: x [B, T, D]
    (T <= 8), ctx [B, N, 6, D] -> (y [B, T, D] in x's dtype, new ctx
    [B, N, 6, D] in ctx's dtype)."""
    b, t, d = x.shape
    n = packed["vecs"].shape[0]
    h_x = x.float()
    new_ctx = []
    for i in range(n):
        vecs = packed["vecs"][i]
        taps = packed["mixw"][i, :7]
        c = ctx[:, i].float()                                  # [B, 6, D]
        h = _rms(h_x, eps) * vecs[0]
        full = torch.cat([c, h], dim=1)                        # [B, 6 + T, D]
        new_ctx.append(full[:, t:])
        m = torch.zeros_like(h)
        for k in range(7):
            m = m + full[:, k:k + t] * taps[k]
        y = h_x + vecs[2] * (m + vecs[1])
        hn = _rms(y, eps) * vecs[3]
        a = (hn @ unpack_int4(packed["w1q"][i]).float()) * packed["sb1"][i, 0] \
            + packed["sb1"][i, 1]
        a = F.gelu(a, approximate="none")
        acc = a @ unpack_int4(packed["w2q"][i]).float()
        h_x = y + vecs[4] * (acc * packed["s2"][i, 0] + vecs[5])
    return h_x.to(x.dtype), torch.stack(new_ctx, dim=1).to(ctx.dtype)


def _check(packed, x, ctx):
    b, t, d = x.shape
    n, _, pd = packed["vecs"].shape
    f = packed["w1q"].shape[2]
    if not 1 <= t <= 8:
        raise ValueError(f"the chain kernel takes 1..8 frames, got {t}")
    if d % 2 or f % 2 or pd != d:
        raise ValueError(f"the chain kernel takes even D and F matching the pack; "
                         f"got D={d}, F={f}, pack D={pd}")
    want = {"vecs": (n, 8, d), "mixw": (n, 8, d), "w1q": (n, d // 2, f),
            "sb1": (n, 2, f), "w2q": (n, f // 2, d), "s2": (n, 1, d)}
    for k, shape in want.items():
        if tuple(packed[k].shape) != shape:
            raise ValueError(f"pack {k} has shape {tuple(packed[k].shape)}, want {shape}")
        if packed[k].dtype != (torch.int8 if k in ("w1q", "w2q") else torch.float32):
            raise TypeError(f"pack {k} has dtype {packed[k].dtype}")
    if tuple(ctx.shape) != (b, n, CTX, d):
        raise ValueError(f"ctx {tuple(ctx.shape)} does not fit x {tuple(x.shape)} and {n} blocks")
    if x.dtype not in _DTYPE_CODES or ctx.dtype != x.dtype:
        raise TypeError(f"x and ctx must share float32 or bfloat16, got {x.dtype}/{ctx.dtype}")
    for tns in [x, ctx, *packed.values()]:
        if tns.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on {tns.device}")
        if not tns.is_contiguous():
            raise ValueError("fused_block_chain_batched operands must be contiguous")


def fused_block_chain_batched(packed, x: torch.Tensor, ctx: torch.Tensor,
                              eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4-pack chain for a batch: x [B, T, D] (T <= 8), ctx [B, N, 6, D] ->
    (y [B, T, D], new_ctx [B, N, 6, D]).  CUDA tensors launch the kernel (one
    cooperative launch, counted once); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_block_chain_batched_ref(packed, x, ctx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_chain_batched runs on cuda or cpu, not {x.device}")
    _check(packed, x, ctx)
    b, t, d = x.shape
    n = packed["vecs"].shape[0]
    f = packed["w1q"].shape[2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tf, ntiles = ffn_tile(f, 2 * sms)  # two CTAs per SM co-reside
    bg = row_group(b, t, d)
    y = torch.empty_like(x)
    new_ctx = torch.empty_like(ctx)
    xg = torch.empty((b * t, d), dtype=torch.float32, device=x.device)
    yg = torch.empty_like(xg)
    part = torch.empty((ntiles, bg * t, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().vv_fused_block_chain(
            x.data_ptr(), ctx.data_ptr(), packed["vecs"].data_ptr(), packed["mixw"].data_ptr(),
            packed["w1q"].data_ptr(), packed["sb1"].data_ptr(), packed["w2q"].data_ptr(),
            packed["s2"].data_ptr(), y.data_ptr(), new_ctx.data_ptr(), xg.data_ptr(),
            yg.data_ptr(), part.data_ptr(), b, t, d, f, n, bg, tf, ntiles, float(eps),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_block_chain kernel failed with code {rc}")
    fused_block_chain_batched.launches += 1
    return y, new_ctx


fused_block_chain_batched.launches = 0


def fused_block_chain(packed, x: torch.Tensor, ctx: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain for ONE batch row: x [T, D], ctx [N, 6, D].  int4 packs only:
    a plain pack is the single-row bf16 kernel, not ported yet (ROADMAP B6)."""
    if "w1q" not in packed:
        refuse_plain_chain()
    y, new_ctx = fused_block_chain_batched(packed, x[None], ctx[None], eps=eps)
    return y[0], new_ctx[0]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_block_chain")
    fn = lib.vv_fused_block_chain
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def pack_bytes(packed) -> int:
    """Bytes of a stage pack (what one chain call streams, weights and vectors)."""
    return sum(t.numel() * t.element_size() for t in packed.values())


__all__ = ["CTX", "ffn_tile", "row_group", "pack_stage", "refuse_plain_chain", "pack_stage_q",
           "fused_block_chain", "fused_block_chain_batched", "fused_block_chain_batched_ref", "pack_bytes"]
