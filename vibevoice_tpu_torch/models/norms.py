"""Normalization numerics shared across all model components.

Port of `vibevoice_tpu/models/norms.py`: normalize in float32, cast back to
the input dtype, then apply the (un-upcast) affine weight, matching the
reference's fp32-upcast RMSNorm.
"""
from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """RMSNorm over the last axis with the statistic taken in fp32."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    out = normed.to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with the statistics and the affine step in
    fp32, cast back to the input dtype (ref ConvLayerNorm :39-51)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    normed = normed * weight.float() + bias.float()
    return normed.to(x.dtype)


__all__ = ["rms_norm", "layer_norm"]
