"""Absorbed latent-attention decode (DeepSeek-V2 MLA) over the stacked latent
cache: CUDA kernel and plain version.

`mla_decode_attention` replaces no TPU kernel (the JAX package has no latent
attention): it is the decode attention of `models/deepseek_v2.py`.  On a CUDA
tensor it makes ONE launch of `csrc/mla_decode_attention.cu` (design and bound
are described there: the visible latent slots, read once for all 16 heads,
over 3.35 TB/s; splits sized on the device from `lengths`, each compacting
its visible slots, merged by tickets); on a CPU tensor it runs
`mla_decode_attention_ref`, the plain PyTorch version with the same
signature, which is also the kernel's oracle.  The kernel's workspace is
cached per device, stream and shape (`workspace`).

Layout: q [B, H, C] (per head the absorbed query over the latent's C =
kv_lora + rope dims); cache [L, B, S, C], read at `layer`; visible [B, S]
int32; lengths [B] int32 with every visible slot of row b below lengths[b].
The output [B, H, kv_lora] is the softmax-weighted sum of the slots' first
kv_lora dims.  A row that sees no slot returns zeros.  The kernel takes the
DeepSeek-V2 shape: H = 16, C = 576, kv_lora = 512, bf16.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e30
HEADS, WIDTH, V_WIDTH = 16, 576, 512   # the kernel's shape (H, C, DV in the source)
TILE = 32          # slots a tile (TILE in the source)
MAX_SPLIT = 2048   # slots a split at most (MAX_SPLIT in the source)
GROUP = 8          # splits merged together before their groups are (GROUP in the source)


def mla_decode_attention_ref(q, cache, layer: int, visible, lengths, scale: float,
                             v_width: int = V_WIDTH):
    """Plain PyTorch absorbed decode attention (fp32 math, output in q's dtype)."""
    b, h, c = q.shape
    s = cache.shape[2]
    lat = cache[layer].float()                                  # [B, S, C]
    logits = torch.einsum("bhc,bsc->bhs", q.float(), lat) * scale
    slots = torch.arange(s, device=q.device)
    mask = ((visible > 0) & (slots[None, :] < lengths.to(q.device)[:, None]))[:, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhs,bsc->bhc", p, lat[..., :v_width]) / denom
    return out.to(q.dtype)


def _check(q, cache, layer, visible, lengths):
    if q.dim() != 3 or cache.dim() != 4:
        raise ValueError(f"q must be [B, H, C] and the cache [L, B, S, C], got "
                         f"{tuple(q.shape)} and {tuple(cache.shape)}")
    b, h, c = q.shape
    n_layers, cb, s, cc = cache.shape
    if (h, c, cc) != (HEADS, WIDTH, WIDTH) or cb != b:
        raise ValueError(f"kernel takes q [B, {HEADS}, {WIDTH}] over a cache [L, B, S, {WIDTH}]; "
                         f"got q {tuple(q.shape)}, cache {tuple(cache.shape)}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16:
        raise TypeError(f"q and the cache must be bfloat16, got {q.dtype} and {cache.dtype}")
    if visible.shape != (b, s) or visible.dtype != torch.int32:
        raise TypeError(f"visible must be int32 [{b}, {s}], got {visible.dtype} "
                        f"{tuple(visible.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}")
    for t in (q, cache, visible, lengths):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("mla_decode_attention operands must be contiguous")
    for name, t in (("q", q), ("cache", cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel's "
                             f"cp.async loads are 16 bytes)")


def mla_decode_attention(q, cache, layer: int, visible, lengths, scale: float,
                         v_width: int = V_WIDTH):
    """Returns [B, H, v_width] in q's dtype.  CUDA tensors launch the kernel
    (and count one launch); CPU tensors take `mla_decode_attention_ref`."""
    if q.device.type == "cpu":
        return mla_decode_attention_ref(q, cache, layer, visible, lengths, scale, v_width)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode_attention runs on cuda or cpu, not {q.device}")
    if v_width != V_WIDTH:
        raise ValueError(f"kernel returns the first {V_WIDTH} dims, not {v_width}")
    _check(q, cache, layer, visible, lengths)
    b = q.shape[0]
    n_layers, _, s, _ = cache.shape
    n_splits = plan(b, s, cuda_build.sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc, part_ml, counters = workspace(q.device, stream, b, n_splits)
    out = torch.empty((b, HEADS, V_WIDTH), dtype=q.dtype, device=q.device)
    rc = _library().vv_mla_decode_attention(
        q.data_ptr(), cache.data_ptr(), visible.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(), b, s, n_layers, layer,
        n_splits, ctypes.c_float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode_attention kernel failed with code {rc}")
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, sms: int) -> int:
    """Splits per row, from the shapes alone (the live length is read on the
    device): about 4/3 CTAs an SM over half the rows (an engine's B
    CFG-negative rows see few slots), at most one per 32-slot tile, and
    enough that no split exceeds MAX_SPLIT slots.  Measured at the 45k
    DeepSeek-V2-Lite cell's operands (B = 8; NVIDIA H100 80GB HBM3): 26 /
    33 / 44 / 52 / 66 splits took 186 / 158 / 138 / 153 / 178 us a launch
    (PERF.md §6, row 10)."""
    want = -(-8 * sms // (3 * b))
    return max(-(-s // MAX_SPLIT), min(-(-s // TILE), want))


_WORKSPACE = {}


def workspace(device, stream: int, b: int, n_splits: int):
    """The kernel's workspace, made once per device, stream and shape: with
    groups = ceil(n_splits / GROUP), the fp32 partials of the splits and then
    of their groups, part_acc [B, n_splits + groups, 16, 512] and part_ml
    [B, n_splits + groups, 16, 2], and the int32 ticket counters
    [B * (1 + groups)].  Every call leaves the counters at 0."""
    key = (str(device), stream, b, n_splits)
    ws = _WORKSPACE.get(key)
    if ws is None:
        groups = -(-n_splits // GROUP)
        f32 = dict(dtype=torch.float32, device=device)
        ws = (torch.empty((b, n_splits + groups, HEADS, V_WIDTH), **f32),
              torch.empty((b, n_splits + groups, HEADS, 2), **f32),
              torch.zeros((b * (1 + groups),), dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mla_decode_attention")
    fn = lib.vv_mla_decode_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def live_bytes(b: int, visible_slots: int, lengths_sum: int, width: int = WIDTH,
               heads: int = HEADS, v_width: int = V_WIDTH, elem: int = 2) -> int:
    """Bytes the call must move: q in, out back, each visible slot once, and
    the visibility mask up to each row's length with the lengths."""
    return (b * heads * (width + v_width) * elem + visible_slots * width * elem
            + 4 * lengths_sum + 4 * b)


__all__ = ["mla_decode_attention", "mla_decode_attention_ref", "plan", "workspace", "live_bytes",
           "NEG_INF"]
