"""Flash prefill attention: CUDA kernel and plain version.

`flash_attention_prefill` replaces the TPU kernel
`vibevoice_tpu/ops/flash_attention.py:flash_attention_prefill` (Pallas
`_flash_kernel`): causal GQA attention over a left-padded prompt in memory
linear in its length, so a long prompt never builds a [T, S] score matrix.
On CUDA tensors it launches `csrc/flash_prefill.cu` (design and bound are
described there); on CPU tensors it runs `flash_attention_prefill_ref`, the
plain PyTorch version with the same signature, which is also the kernel's
oracle.

Layout (the JAX package's): q [B, T, H, D]; k/v [B, S, KVH, D]; pad_mask
[B, S] int (1 = a real key); query row i sits at global position
row_offset + i (0 without `row_offset`: T == S self-attention).  Query head h
reads KV head h // (H / KVH).  Scores are summed in fp32, the probabilities
are rounded to v's dtype before P·V, and the normalizer sums the unrounded
ones, as in the TPU kernel.

A query row that sees no key (a left-pad row) returns zeros: its masked
probabilities are zeroed explicitly, so every output row is finite whatever
the keys hold.  The TPU kernel returns a tiling-dependent average there; the
engine reads no such row, and the rows that see a key agree.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_REF_ROWS = 512  # query rows per chunk of the plain version (bounds its memory)


def _offset(row_offset) -> int:
    if row_offset is None:
        return 0
    if torch.is_tensor(row_offset):
        return int(row_offset.reshape(-1)[0])
    return int(row_offset)


def flash_attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                pad_mask: torch.Tensor, causal: bool = True,
                                row_offset=None) -> torch.Tensor:
    """Plain PyTorch version: [B, T, H, D] in q's dtype, fp32 math, query rows
    in chunks of 512 so that its memory stays linear in T."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    off = _offset(row_offset)
    scale = 1.0 / math.sqrt(d)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]            # [B, KVH, 1, D, S]
    vt = v.float().transpose(1, 2)[:, :, None]                # [B, KVH, 1, S, D]
    keys = torch.arange(s, device=q.device)
    key_ok = (pad_mask.to(q.device) > 0)[:, None, None, None, :]   # [B, 1, 1, 1, S]
    out = torch.empty_like(q)
    for t0 in range(0, t, _REF_ROWS):
        t1 = min(t, t0 + _REF_ROWS)
        qc = q[:, t0:t1].float().reshape(b, t1 - t0, kvh, g, d).permute(0, 2, 3, 1, 4)
        sc = torch.matmul(qc, kt) * scale                     # [B, KVH, G, tq, S]
        ok = key_ok
        if causal:
            rows = off + torch.arange(t0, t1, device=q.device)
            ok = ok & (keys[None, :] <= rows[:, None])
        sc = torch.where(ok, sc, NEG_INF)
        p = torch.where(ok, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vt) / l.clamp_min(1e-30)
        out[:, t0:t1] = o.permute(0, 3, 1, 2, 4).reshape(b, t1 - t0, h, d).to(q.dtype)
    return out


def _check(q, k, v, pad_mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, T, H, D] and k/v one [B, S, KVH, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    kb, s, kvh, kd = k.shape
    if kb != b or kd != d or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the flash prefill kernel takes head_dim {_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if tuple(pad_mask.shape) != (b, s) or pad_mask.dtype != torch.int32:
        raise TypeError(f"pad_mask must be int32 [{b}, {s}], got {pad_mask.dtype} "
                        f"{tuple(pad_mask.shape)}")
    for tns in (q, k, v, pad_mask):
        if tns.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, one is on {tns.device}")
        if not tns.is_contiguous() or tns.data_ptr() % 16:
            raise ValueError("flash_attention_prefill operands must be contiguous and "
                             "16-byte aligned")


def cta_rows(b: int, t: int, h: int, kvh: int, sms: int) -> int:
    """Query rows per CTA of the bf16 kernel: 128 (two consumer warpgroups)
    where 128-row tiles give every SM a CTA, else 64 (one warpgroup, twice
    the CTAs)."""
    tiles = -(-t * (h // kvh) // 128)
    return 128 if tiles * kvh * b >= sms else 64


def flash_attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pad_mask: torch.Tensor, causal: bool = True,
                            row_offset: Optional[int] = None) -> torch.Tensor:
    """Memory-linear prefill attention: [B, T, H, D] in q's dtype.  CUDA
    tensors launch the kernel (one launch, counted), its CTA height chosen by
    `cta_rows`; CPU tensors take `flash_attention_prefill_ref`."""
    if q.device.type == "cpu":
        return flash_attention_prefill_ref(q, k, v, pad_mask, causal, row_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_prefill runs on cuda or cpu, not {q.device}")
    _check(q, k, v, pad_mask)
    b, t, h, _ = q.shape
    rows = cta_rows(b, t, h, k.shape[2], cuda_build.sm_count(q.device))
    return flash_attention_prefill_at(q, k, v, pad_mask, rows, causal, row_offset)


def flash_attention_prefill_at(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               pad_mask: torch.Tensor, rows: int, causal: bool = True,
                               row_offset: Optional[int] = None) -> torch.Tensor:
    """`flash_attention_prefill` at a CTA height of `rows` (64 or 128) query
    rows, which the bf16 kernel takes and the fp32 one ignores: a way to time
    the two heights against each other.  CUDA tensors launch the kernel (one
    launch, counted); CPU tensors take `flash_attention_prefill_ref`."""
    if q.device.type == "cpu":
        return flash_attention_prefill_ref(q, k, v, pad_mask, causal, row_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_prefill runs on cuda or cpu, not {q.device}")
    _check(q, k, v, pad_mask)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library().vv_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_mask.data_ptr(), out.data_ptr(),
            b, t, s, h, kvh, d, _offset(row_offset), int(bool(causal)), int(rows),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel failed with code {rc}")
    flash_attention_prefill.launches += 1
    return out


flash_attention_prefill.launches = 0


def flash_attention_prefill_sharded(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    pad_mask: torch.Tensor,
                                    num_key_value_heads: Optional[int] = None) -> torch.Tensor:
    """Tensor-parallel flash prefill (the JAX package's
    `flash_attention_prefill_sharded`): a rank passes ITS heads, q
    [B, T, H/mp, D] and k/v [B, S, KVH/mp, D], and attends them alone.
    ValueError when the shard's KV heads are not KVH/mp
    (`num_key_value_heads`, the model's KVH, when given).  `qwen2.forward`
    calls `flash_attention_prefill` on its local heads directly: the engine
    has checked the split."""
    mp = mesh.shape["model"]
    if num_key_value_heads is not None and (num_key_value_heads % mp
                                            or num_key_value_heads // mp != k.shape[2]):
        raise ValueError(f"model axis {mp} must divide num_key_value_heads "
                         f"{num_key_value_heads} into this shard's {k.shape[2]} KV heads")
    return flash_attention_prefill(q, k, v, pad_mask)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_prefill")
    fn = lib.vv_flash_prefill
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib


def attended_pairs(pad_mask: torch.Tensor, t: int, causal: bool = True, row_offset=None) -> int:
    """(query row, key) pairs that the real query rows of this input attend:
    query row i sits at global position p = row_offset + i, is real where
    pad_mask[p] is, and sees the real keys at or before p (every real key
    without `causal`).  A call needs 4 * D * H flops per pair (q.k and p.v)."""
    pad = (pad_mask > 0).to(torch.int64)
    s = pad.shape[1]
    idx = (_offset(row_offset) + torch.arange(t, device=pad.device)).clamp(0, s - 1)
    seen = pad.cumsum(dim=1)
    per_row = seen[:, idx] if causal else seen[:, -1:].expand(-1, t)
    return int((per_row * pad[:, idx]).sum())


__all__ = ["flash_attention_prefill", "flash_attention_prefill_at",
           "flash_attention_prefill_sharded", "flash_attention_prefill_ref",
           "attended_pairs", "cta_rows", "NEG_INF"]
