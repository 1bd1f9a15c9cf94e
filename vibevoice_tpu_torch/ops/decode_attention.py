"""Decode attention over the stacked KV cache: CUDA kernel and plain version.

`decode_attention` replaces the TPU kernel
`vibevoice_tpu/ops/decode_attention.py:decode_attention` (Pallas `_kernel`).
On a CUDA tensor it launches the split-K kernel of `csrc/decode_attention.cu`
(design and bound are described there: the live K/V prefix, plus scales, over
3.35 TB/s); on a CPU tensor it runs `decode_attention_ref`, the plain PyTorch
version with the same signature, which is also the kernel's oracle.

Layout (the JAX package's): q [B, H, D]; k/v [L, B, S, KVH*D] (the whole
stacked cache, read at `layer`); visible [B, S] int32; lengths [B] int32 with
every visible slot of row b below lengths[b]; for an int8 cache, per-slot
scales k_scale/v_scale [L, B, 8, S] bf16.  A row must see at least one slot;
one that sees none returns zeros.
"""
from __future__ import annotations

import ctypes
import torch

from . import cuda_build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_CHUNK = 128  # cache slots per block of the split kernel (CHUNK in the source)


def decode_attention_ref(q, k_full, v_full, layer: int, visible, lengths,
                         k_scale=None, v_scale=None):
    """Plain PyTorch decode attention (fp32 math, output in q's dtype)."""
    b, h, d = q.shape
    s = k_full.shape[2]
    kvh = k_full.shape[3] // d
    g = h // kvh
    k = k_full[layer].float().view(b, s, kvh, d)
    v = v_full[layer].float().view(b, s, kvh, d)
    logits = torch.einsum("bkgd,bskd->bkgs", q.float().view(b, kvh, g, d), k) * (d ** -0.5)
    if k_scale is not None:
        logits = logits * k_scale[layer, :, 0].float()[:, None, None, :]
    slots = torch.arange(s, device=q.device)
    mask = (visible > 0) & (slots[None, :] < lengths.to(q.device)[:, None])
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        p = p * v_scale[layer, :, 0].float()[:, None, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / denom
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k_full, v_full, layer, visible, lengths, k_scale, v_scale):
    b, h, d = q.shape
    if k_full.dim() != 4 or k_full.shape != v_full.shape:
        raise ValueError(f"k/v must be one [L, B, S, KVH*D] shape, got "
                         f"{tuple(k_full.shape)} and {tuple(v_full.shape)}")
    n_layers, kb, s, f = k_full.shape
    if kb != b or f % d or h % (f // d):
        raise ValueError(f"cache {tuple(k_full.shape)} does not fit q {tuple(q.shape)}")
    if d not in (64, 128) or h // (f // d) > 8:
        raise ValueError(f"kernel takes head_dim 64 or 128 and at most 8 query heads "
                         f"per KV head; got D={d}, G={h // (f // d)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_scale is not None
    want_kv = torch.int8 if quant else q.dtype
    if k_full.dtype != want_kv or v_full.dtype != want_kv:
        raise TypeError(f"cache must be {want_kv} for q {q.dtype} "
                        f"(quantized={quant}), got {k_full.dtype}")
    if quant:
        if v_scale is None or k_scale.shape != (n_layers, b, 8, s) \
                or v_scale.shape != k_scale.shape:
            raise ValueError("int8 cache needs k_scale and v_scale of shape [L, B, 8, S]")
        if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
            raise TypeError("cache scales must be bfloat16")
    elif v_scale is not None:
        raise ValueError("v_scale given without k_scale")
    if visible.shape != (b, s) or visible.dtype != torch.int32:
        raise TypeError(f"visible must be int32 [{b}, {s}], got "
                        f"{visible.dtype} {tuple(visible.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} "
                        f"{tuple(lengths.shape)}")
    tensors = [q, k_full, v_full, visible, lengths] + ([k_scale, v_scale] if quant else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("decode_attention operands must be contiguous")


def decode_attention(q, k_full, v_full, layer: int, visible, lengths,
                     k_scale=None, v_scale=None):
    """Returns [B, H, D] in q's dtype.  CUDA tensors launch the kernel (and
    count one launch); CPU tensors take `decode_attention_ref`."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_full, v_full, layer, visible, lengths,
                                    k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_full, v_full, layer, visible, lengths, k_scale, v_scale)
    b, h, d = q.shape
    n_layers, _, s, f = k_full.shape
    kvh = f // d
    n_chunks = -(-s // _CHUNK)
    # the partials live on the launch stream: the caching allocator hands
    # their memory to no other stream's work before the kernels have run
    out = torch.empty_like(q)
    part_acc = torch.empty((b, h, n_chunks, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, n_chunks, 2), dtype=torch.float32, device=q.device)
    lib = _library()
    quant = k_scale is not None
    rc = lib.vv_decode_attention(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        visible.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        b, h, kvh, d, s, n_layers, layer, n_chunks,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_full.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel failed with code {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("decode_attention")
    fn = lib.vv_decode_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib


def live_bytes(q, k_full, lengths, quant: bool) -> int:
    """Bytes the call must move: q in, out back, and the live K/V prefix of the
    layer (each row up to its length), plus the bf16 scales per live slot when
    the cache is int8.  The mask and lengths are counted too."""
    b, h, d = q.shape
    f = k_full.shape[3]
    live = int(lengths.clamp(0, k_full.shape[2]).sum())
    kv = 2 * live * f * k_full.element_size()
    scales = 2 * live * 2 if quant else 0
    return 2 * q.numel() * q.element_size() + kv + scales + live * 4 + b * 4


__all__ = ["decode_attention", "decode_attention_ref", "live_bytes", "NEG_INF"]
