"""Context-parallel (sequence-sharded) prefill attention.

Port of `vibevoice_tpu/parallel/context_parallel.py`.  Each rank of a mesh
axis holds T/n consecutive query rows with their keys, values and pad mask;
the keys, values and pads are all-gathered over the axis (one collective, in
rank order), and each rank attends its own rows causally with their global
offset `rank * T/n`: on the card through the flash prefill kernel with
`row_offset` and T != S, on the CPU through its plain version.  Activation
memory O(T/n) a rank beside the gathered K/V.
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention_prefill
from .mesh import Mesh


def _local_attention_ref(q, k, v, pad_mask, row_offset: int) -> torch.Tensor:
    """Dense masked attention with the global row offset (the JAX package's
    reference path): fp32, a fully masked row averages every key."""
    b, t, h, d = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kr) / (d ** 0.5)
    rows = row_offset + torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = (cols <= rows)[None, None] & (pad_mask > 0)[:, None, None, :]
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, vr).to(q.dtype)


def gather_kv(k: torch.Tensor, v: torch.Tensor, pad_mask: torch.Tensor, mesh: Mesh,
              axis: str = "data"):
    """The axis's K, V [B, S, KVH, D] and pad mask [B, S] from every rank's
    T/n rows, in rank order, through ONE all-gather of the three packed
    together (the pad as 0/1 in K's dtype, which holds it exactly)."""
    b, t, kvh, d = k.shape
    packed = torch.cat([k.reshape(b, t, -1), v.reshape(b, t, -1),
                        pad_mask[..., None].to(k.dtype)], dim=-1)
    full = mesh.all_gather(packed, axis, dim=1)
    s = full.shape[1]
    f = kvh * d
    k_g = full[..., :f].reshape(b, s, kvh, d).contiguous()
    v_g = full[..., f:2 * f].reshape(b, s, kvh, d).contiguous()
    pad_g = full[..., 2 * f].to(torch.int32).contiguous()
    return k_g, v_g, pad_g


def cp_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pad_mask: torch.Tensor, mesh: Mesh, axis: str = "data",
                         use_flash: bool = True) -> torch.Tensor:
    """Sequence-sharded causal self-attention.  Each rank passes ITS rows: q
    [B, T/n, H, D], k/v [B, T/n, KVH, D], pad_mask [B, T/n] int32 (rank r
    holds global rows [r*T/n, (r+1)*T/n)); returns the rank's [B, T/n, H, D].
    `use_flash=False` takes the dense reference path instead of the flash
    prefill wrapper (kernel on the card, plain version on the CPU)."""
    off = mesh.axis_index(axis) * q.shape[1]
    k_g, v_g, pad_g = gather_kv(k, v, pad_mask, mesh, axis)
    if use_flash:
        return flash_attention_prefill(q.contiguous(), k_g, v_g, pad_g, causal=True,
                                       row_offset=off)
    return _local_attention_ref(q, k_g, v_g, pad_g, off)


__all__ = ["cp_prefill_attention", "gather_kv"]
