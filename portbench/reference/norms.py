"""Normalization numerics shared across all model components.

The benchmark's frozen copy of the port's `models/norms.py`: normalize in float32, cast back to
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


__all__ = ["rms_norm"]
