"""Ring attention over a mesh axis for long prefills.

Port of `vibevoice_tpu/parallel/ring_attention.py` (plain torch, as the JAX
version is plain `jnp`).  Unlike `context_parallel.cp_prefill_attention`,
which gathers all K/V (O(T) memory a rank), each rank keeps a T/n slice of Q,
K, V; the K/V blocks travel round the ring, rank r sending its current block
to (r+1) % n and receiving (r-1) % n's, and each rank folds every visiting
block into fp32 online-softmax accumulators: O(T/n) memory.

The exchange is one `all_to_all_single` whose splits send the whole block to
the neighbour and nothing elsewhere: NCCL and gloo both take it for CUDA
tensors (gloo's point-to-point does not promise to), so the same code runs
under either.  K, V and the pad travel packed in one buffer.  n - 1 exchanges
suffice: the JAX version's n-th returns every block to its owner, unread.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

NEG_INF = -1e30


def _fold_block(q, k, v, pad, row_off: int, col_off: int, m, l, acc):
    """Fold one visiting K/V block into the accumulators.  q [B,T,H,D]; k/v
    [B,S,KVH,D]; pad [B,S]; m/l [B,H,T,1], acc [B,H,T,D], all fp32."""
    t, h, d = q.shape[1:]
    g = h // k.shape[2]
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bthd,bshd->bhts", q.float(), kr) / (d ** 0.5)
    rows = row_off + torch.arange(t, device=q.device)[:, None]
    cols = col_off + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (cols <= rows)[None, None] & (pad > 0)[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhts,bshd->bhtd", p, vr)
    return m_new, l_new, acc_new


def _pass_on(k, v, pad, mesh: Mesh, axis: str):
    """Send (k, v, pad) to the next rank of the ring and return the previous
    rank's, through one all_to_all_single."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    buf = torch.cat([k.reshape(-1), v.reshape(-1), pad.reshape(-1).to(k.dtype)])
    out = torch.empty_like(buf)
    send = [0] * n
    recv = [0] * n
    send[(i + 1) % n] = buf.numel()
    recv[(i - 1) % n] = buf.numel()
    dist.all_to_all_single(out, buf, output_split_sizes=recv, input_split_sizes=send,
                           group=mesh.group(axis))
    nk = k.numel()
    return (out[:nk].view_as(k), out[nk:2 * nk].view_as(v),
            out[2 * nk:].view(pad.shape).to(pad.dtype))


def ring_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pad_mask: torch.Tensor, mesh: Mesh,
                           axis: str = "data") -> torch.Tensor:
    """Causal self-attention with ring-passed K/V.  Each rank passes ITS rows
    (q [B, T/n, H, D], k/v [B, T/n, KVH, D], pad_mask [B, T/n]; rank r holds
    global rows [r*T/n, (r+1)*T/n)) and gets its [B, T/n, H, D] back."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    b, t, h, d = q.shape
    row_off = i * t
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    k_c, v_c, pad_c = k, v, pad_mask
    for step in range(n):
        src = (i - step) % n  # the block held now came from rank (i - step) mod n
        m, lsum, acc = _fold_block(q, k_c, v_c, pad_c, row_off, src * t, m, lsum, acc)
        if step < n - 1:
            k_c, v_c, pad_c = _pass_on(k_c, v_c, pad_c, mesh, axis)
    out = (acc / lsum.clamp_min(1e-30)).transpose(1, 2)  # -> [B, T, H, D]
    return out.to(q.dtype)


__all__ = ["ring_prefill_attention"]
