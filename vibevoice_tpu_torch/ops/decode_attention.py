"""Decode attention over the stacked KV cache: CUDA kernel and plain version.

`decode_attention` replaces the TPU kernel
`vibevoice_tpu/ops/decode_attention.py:decode_attention` (Pallas `_kernel`).
On a CUDA tensor it makes ONE launch of `csrc/decode_attention.cu` (design and
bound are described there: the live K/V prefix, plus scales, over 3.35 TB/s;
splits sized on the device from `lengths`, merged by the last CTA of each
(row, KV head)); on a CPU tensor it runs `decode_attention_ref`, the plain
PyTorch version with the same signature, which is also the kernel's oracle.
The kernel's workspace (fp32 partials and the ticket counters) is cached per
device, stream and shape (`workspace`), so a call allocates only its output.

Layout (the JAX package's): q [B, H, D]; k/v [L, B, S, KVH*D] (the whole
stacked cache, read at `layer`); visible [B, S] int32; lengths [B] int32 with
every visible slot of row b below lengths[b]; for an int8 cache, per-slot
scales k_scale/v_scale [L, B, 8, S] bf16.  A row must see at least one slot;
one that sees none returns zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TILE = 64    # cache slots per staged tile of the bf16 kernel (TILE in the source)
CHUNK = 128  # cache slots per CTA of the fp32 kernel (CHUNK in the source)
GROUP = 8    # splits merged together before their groups are (GROUP in the source)
# CTAs per SM the tensor-core grid aims at, over all (row, KV head) pairs:
# as many as an SM holds at once (bf16: two; int8, with its smaller ring and
# register cap: three)
SPLITS_PER_SM = {torch.bfloat16: 2, torch.int8: 3}


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
    n_splits = plan(b, kvh, s, q.dtype, cuda_build.sm_count(q.device), k_full.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc, part_ml, counters = workspace(q.device, stream, b, kvh, n_splits, h // kvh, d)
    out = torch.empty_like(q)
    quant = k_scale is not None
    rc = _library().vv_decode_attention(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        visible.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(),
        b, h, kvh, d, s, n_layers, layer, n_splits,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_full.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel failed with code {rc}")
    decode_attention.launches += 1
    return out


def decode_attention_sharded(mesh, q, k_full, v_full, layer: int, visible, lengths,
                             k_scale=None, v_scale=None, num_key_value_heads=None):
    """Tensor-parallel decode attention (the JAX package's
    `decode_attention_sharded`): a rank passes ITS shard, q [B, H/mp, D] and
    the cache's (KVH/mp)*D lanes, and the kernel reads those lanes alone.
    The slot scales of an int8 cache cover the whole slot and are the same on
    every rank.  ValueError when the shard's KV heads are not KVH/mp
    (`num_key_value_heads`, the model's KVH, when given).  `qwen2.forward`
    calls `decode_attention` on its local heads directly: the engine has
    checked the split."""
    mp, kvh = mesh.shape["model"], k_full.shape[3] // q.shape[-1]
    if num_key_value_heads is not None and (num_key_value_heads % mp
                                            or num_key_value_heads // mp != kvh):
        raise ValueError(f"model axis {mp} must divide num_key_value_heads "
                         f"{num_key_value_heads} into this shard's {kvh} KV heads")
    return decode_attention(q, k_full, v_full, layer, visible, lengths,
                            k_scale=k_scale, v_scale=v_scale)


@functools.lru_cache(maxsize=None)
def plan(b: int, kvh: int, s: int, q_dtype: torch.dtype, sms: int,
         kv_dtype: torch.dtype = torch.bfloat16) -> int:
    """Splits per (row, KV head) of the kernel's grid, a function of the
    shapes alone (the live length is read on the device).  bf16 q: enough
    that the B*KVH pairs give about SPLITS_PER_SM[kv_dtype] CTAs per SM, at
    most one per 64-slot tile of the cache; fp32: one per 128-slot chunk."""
    if q_dtype == torch.float32:
        return -(-s // CHUNK)
    return max(1, min(-(-s // TILE), -(-SPLITS_PER_SM[kv_dtype] * sms // (b * kvh))))


def split_of(length: int, n_splits: int, s: int):
    """(split length, splits with work) that the bf16 kernel computes on the
    device for a row of `length` live slots (`split_range` in the source):
    the live prefix over n_splits, rounded up to whole 64-slot tiles; at
    least one split, so a row with no live slot still writes its zeros."""
    length = min(max(length, 0), s)
    per = max(TILE, -(-length // (n_splits * TILE)) * TILE)
    return per, max(1, -(-length // per))


_WORKSPACE = {}


def workspace(device, stream: int, b: int, kvh: int, n_splits: int, g: int, d: int):
    """The kernel's workspace, made once per device, stream and shape: with
    groups = ceil(n_splits / GROUP), the fp32 partials of the splits and then
    of their groups, part_acc [B*KVH, n_splits + groups, G, D] and part_ml
    [B*KVH, n_splits + groups, G, 2], and the int32 ticket counters
    [B*KVH * (1 + groups)] (per row and KV head, then per group).  The
    counters start at 0 and every call leaves them at 0; calls on one stream
    run in order, so they share the buffers safely."""
    key = (str(device), stream, b, kvh, n_splits, g, d)
    ws = _WORKSPACE.get(key)
    if ws is None:
        f32 = dict(dtype=torch.float32, device=device)
        n = n_splits + -(-n_splits // GROUP)
        ws = (torch.empty((b * kvh, n, g, d), **f32), torch.empty((b * kvh, n, g, 2), **f32),
              torch.zeros((b * kvh * (1 + -(-n_splits // GROUP)),), dtype=torch.int32,
                          device=device))
        _WORKSPACE[key] = ws
    return ws


decode_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("decode_attention")
    fn = lib.vv_decode_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 10 + [p]
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


__all__ = ["decode_attention", "decode_attention_ref", "decode_attention_sharded", "live_bytes", "plan", "split_of",
           "workspace",
           "NEG_INF"]
