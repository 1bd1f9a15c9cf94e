"""int4 weight-only matmul for decode GEMVs: CUDA kernel and plain version.

Port of `vibevoice_tpu/ops/int4_matmul.py`.  Weights keep the JAX package's
layout, so a tree quantized there carries over as it is:

  * packed int8 `[K/2, N]`, rows INTERLEAVED: byte row i holds original row 2i
    in its low nibble and row 2i+1 in its high nibble; nibbles are signed,
    in [-8, 7];
  * fp32 scales `[1, N]` (per output channel) or `[K/gs, N]` (per group of
    `gs` rows, `K % gs == 0`).

Rounding order (the JAX kernel's): per channel, the dot accumulates in fp32,
then the fp32 scale is applied, then the result is cast to x's dtype; per
group, each weight is multiplied by its scale in x's dtype before the dot.

`int4_matmul` replaces the TPU kernel `vibevoice_tpu/ops/int4_matmul.py:
int4_matmul` (Pallas `_kernel`).  On a CUDA tensor it launches the split-K
GEMV of `csrc/int4_matmul.cu`, one launch per call whose K splits meet in
a thread-block cluster (design and bound are described there); on a CPU
tensor it runs `int4_matmul_ref`, the plain version with the same signature,
which is also the kernel's oracle.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COLS = 128            # output columns per CTA (COLS in the source)
_PASS_ROWS = 16        # rows of x per CTA (bf16; fp32 takes 4)
_XS_BYTES = 98304      # a CTA's staged x slice, at most (XS_BYTES)
_SPLITS = 8            # K splits of a column tile at most: one portable cluster
_MAX_M = 128           # rows the kernel takes; larger M dequantizes (quantize.mm)
# XLA folds `amax / 7.0` into a product with the fp32 reciprocal of 7; the
# same product keeps the scales bit-equal to the JAX package's
_RECIP_7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Interleave-pack int4 values [K, N] (in [-8, 7]) into int8 [K/2, N]:
    byte row i = (low nibble: row 2i, high nibble: row 2i+1)."""
    k = q.shape[0]
    if k % 2:
        raise ValueError("K must be even to nibble-pack")
    q = q.to(torch.int32)
    lo, hi = q[0::2], q[1::2]
    packed_u8 = (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8)
    return packed_u8.contiguous().view(torch.int8)


def quantize_int4(w: torch.Tensor, group_size: Optional[int] = None):
    """Symmetric int4: w [K, N] -> {"qint4": packed int8 [K/2, N],
    "scale4": fp32 [1, N] or [K/group_size, N]}.  fp32 math; `torch.round`
    rounds half to even, as `jnp.round` does."""
    wf = w.float()
    k, n = wf.shape
    if group_size is None:
        amax = wf.abs().amax(dim=0, keepdim=True)
        scale = torch.clamp_min(amax * _RECIP_7, 1e-8)
        q = torch.clamp(torch.round(wf / scale), -8, 7)
    else:
        if k % group_size or group_size % 2:
            raise ValueError(f"group size {group_size} must be even and divide K={k}")
        g = wf.reshape(k // group_size, group_size, n)
        amax = g.abs().amax(dim=1)
        scale = torch.clamp_min(amax * _RECIP_7, 1e-8)
        q = torch.clamp(torch.round(g / scale[:, None]), -8, 7).reshape(k, n)
    return {"qint4": pack_int4(q), "scale4": scale.float()}


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed int8 [K/2, N] -> the signed int4 values as int32 [K, N]."""
    u = packed.view(torch.uint8).to(torch.int32)
    kh, n = packed.shape
    w = torch.empty((2 * kh, n), dtype=torch.int32, device=packed.device)
    w[0::2] = ((u & 0xF) ^ 8) - 8
    w[1::2] = ((u >> 4) ^ 8) - 8
    return w


def dequant_int4(packed: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Materialized dequantization (the JAX package's `dequant_int4_xla`):
    the int4 values times the fp32 scales in fp32, cast to `dtype`.  For
    prefill, where the weight read amortizes over many rows."""
    w = unpack_int4(packed).float()
    k, n = w.shape
    g = scale.shape[0]
    if g == 1:
        return (w * scale.float()).to(dtype)
    return (w.reshape(g, k // g, n) * scale.float()[:, None]).reshape(k, n).to(dtype)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch int4 matmul, x [M, K] -> [M, N] in x's dtype, with the
    JAX kernel's rounding order."""
    w = unpack_int4(packed)
    k, n = w.shape
    g = scale.shape[0]
    if g == 1:
        acc = x.float() @ w.float()
        return (acc * scale.float()).to(x.dtype)
    s = scale.float().repeat_interleave(k // g, dim=0)
    wq = w.to(x.dtype) * s.to(x.dtype)  # rounded to x's dtype, as in the kernel
    return (x.float() @ wq.float()).to(x.dtype)


def max_kbr(m: int) -> int:
    """Byte rows per split whose x slice fits shared memory: min(M, 16) bf16
    rows or min(M, 4) fp32 rows of 2 * KBR values plus the row padding."""
    bf16 = (_XS_BYTES // (2 * min(m, _PASS_ROWS)) - 8) // 2
    fp32 = (_XS_BYTES // (4 * min(m, 4)) - 4) // 2
    return min(bf16, fp32) // 8 * 8


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int = 132) -> Tuple[int, int]:
    """(byte rows per split, splits) of the kernel's grid of 128-column tiles
    x splits along K x passes of 16 rows: about two CTAs per SM with at most
    8 splits (one portable cluster per tile), whole k16 steps (8 byte rows)
    per split.  A K whose x slices need more splits is refused."""
    kh = k // 2
    tiles = -(-n // _COLS) * -(-m // _PASS_ROWS)
    want = max(1, min(-(-2 * sms // tiles), _SPLITS))
    round8 = lambda v: -(-v // 8) * 8
    kbr = min(max(8, round8(-(-kh // want))), max_kbr(m))  # more splits where x needs them
    if -(-kh // kbr) > _SPLITS:
        raise ValueError(f"K={k} needs more than {_SPLITS} splits of x slices that fit")
    return kbr, -(-kh // kbr)


def _check(x, packed, scale):
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError("int4_matmul takes x [M, K], packed [K/2, N], scale [G, N]")
    m, k = x.shape
    kh, n = packed.shape
    g = scale.shape[0]
    if 2 * kh != k or scale.shape[1] != n:
        raise ValueError(f"packed {tuple(packed.shape)} / scale {tuple(scale.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if g != 1 and (k % g or (k // g) % 2):
        raise ValueError(f"{g} scale groups do not split K={k} into even groups")
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"the kernel takes 1..{_MAX_M} rows, got {m}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("packed must be int8 and scale float32")
    for t in (packed, scale):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on {t.device}")
    for t in (x, packed, scale):
        if not t.is_contiguous():
            raise ValueError("int4_matmul operands must be contiguous")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(packed [K/2, N], scale) -> [M, N] in x's dtype.
    CUDA tensors launch the kernel (and count one launch); CPU tensors take
    `int4_matmul_ref`."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    _check(x, packed, scale)
    m, k = x.shape
    n = packed.shape[1]
    g = scale.shape[0]
    kbr, ksplit = plan(m, k, n, cuda_build.sm_count(x.device))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = _library().vv_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k, n, g, kbr, ksplit, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul kernel failed with code {rc}")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int4_matmul")
    fn = lib.vv_int4_matmul
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return lib


__all__ = ["pack_int4", "quantize_int4", "unpack_int4", "dequant_int4", "int4_matmul",
           "int4_matmul_ref", "plan", "max_kbr"]
