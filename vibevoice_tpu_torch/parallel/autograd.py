"""The collectives of a tensor-parallel layer, as autograd sees them.

A column-split product (q/k/v, gate/up, an untied `lm_head`) takes a
replicated input and gives this rank's columns; a row-split one (o, down)
gives a partial sum that the model group adds up.  Training differentiates
through both, so each collective comes with its adjoint (Megatron's f and g):

  * `copy_to`: identity forward, sum over the axis backward.  It goes at the
    replicated input of every column-split product: each rank's gradient of
    that input covers only its own columns, and the sum makes it whole, so
    every replicated leaf below the split (norms, `embed`, connectors, the
    diffusion head's projections) gets the whole gradient on every rank;
  * `reduce_from`: sum over the axis forward, identity backward.  It goes at
    the output of every row-split product;
  * `gather_last`: the ranks' column slices concatenated along the last
    dimension forward, this rank's slice of the gradient backward (a
    column-split `lm_head`'s logits, whole for the cross-entropy).

Each is a no-op on an axis of size 1.  With gradients off (serving) or on a
tensor that takes none, `copy_to` is the identity and `reduce_from` sums in
place (`Mesh.all_reduce`), as the serving paths always have.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.index, ctx.width = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w:(ctx.index + 1) * w].contiguous(), None, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """`x` (replicated over `axis`), its gradient summed over the axis."""
    g = None if mesh is None else mesh.group(axis)
    if g is None or not _tracked(x):
        return x
    return _CopyTo.apply(x, g)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """`x` summed over `axis`; its gradient passes through unchanged."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return x
    if not _tracked(x):
        return mesh.all_reduce(x, axis)
    return _ReduceFrom.apply(x, g)


def gather_last(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The axis's ranks' `x` concatenated along the last dimension in rank
    order; its gradient is this rank's slice."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return x
    if not _tracked(x):
        return mesh.all_gather(x, axis, dim=-1)
    return _GatherLast.apply(x, g, mesh.shape[axis], mesh.axis_index(axis))


__all__ = ["copy_to", "reduce_from", "gather_last"]
