"""Parameter trees of the port: from the JAX package's pytree, and onto a device.

The port keeps the JAX package's parameter tree and layouts (linear [in, out],
conv [K, Cin, Cout], transposed conv [Cin, K, Cout]), so a
`vibevoice.init_model` pytree converted leaf by leaf with `np.asarray` maps
one to one onto torch tensors.  This is the inverse direction of
`vibevoice_tpu/utils/torch_bridge.py`, which turns reference torch modules into
JAX pytrees.  A tree the JAX package quantized carries over as it is: int8
leaves, the quantized weights' dicts ({"qint8", "scale"}, {"qint4", "scale4"})
and the kernel packs ("_vocoder_packs", "_semantic_packs" keyed by stage index,
"_diffusion_head_packq", and the large-T stage packs "_vocoder_packs_large" /
"_semantic_packs_large", whose folded conv and head are the JAX package's
`ConvPack` / `HeadPack` objects, recognised by their attributes and carried
into the port's classes of the same names).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .ops.fused_stage import ConvPack, HeadPack

_CONV_ATTRS = ("kind", "w", "b", "s", "k", "cin")
_HEAD_ATTRS = ("w", "b", "k", "has_norm")


def _leaf_to_torch(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy path
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point() and t.dim() > 0:
        t = t.to(dtype)
    return t.to(device)


def _keeps_dtypes(key, node) -> bool:
    """Quantized weights and kernel packs keep their stored dtypes (their
    scales are part of the quantized values)."""
    if isinstance(key, str) and key.startswith("_"):
        return True
    return isinstance(node, dict) and ("qint8" in node or "qint4" in node)


def from_jax(params_np: Any, device="cpu", dtype: Optional[torch.dtype] = None) -> Any:
    """numpy pytree (dicts, lists, tuples, None leaves) -> the same tree of
    torch tensors on `device`.  `dtype` recasts the floating arrays, except
    0-dim scalars (the speech scaling factors stay fp32), quantized weights
    and kernel packs."""
    if params_np is None:
        return None
    if isinstance(params_np, dict):
        return {k: from_jax(v, device, None if _keeps_dtypes(k, v) else dtype)
                for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(from_jax(v, device, dtype) for v in params_np)
    if all(hasattr(params_np, a) for a in _CONV_ATTRS):
        p = params_np
        return ConvPack(p.kind, from_jax(p.w, device), from_jax(p.b, device), p.s, p.k, p.cin)
    if all(hasattr(params_np, a) for a in _HEAD_ATTRS):
        p = params_np
        return HeadPack(from_jax(p.w, device), from_jax(p.b, device), p.k, p.has_norm)
    return _leaf_to_torch(params_np, device, dtype)


def to_device(params: Any, device) -> Any:
    """The same tree with every tensor on `device` (no copy where it already is)."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_device(v, device) for v in params)
    if isinstance(params, (torch.Tensor, ConvPack, HeadPack)):
        return params.to(device)
    return params


__all__ = ["from_jax", "to_device"]
