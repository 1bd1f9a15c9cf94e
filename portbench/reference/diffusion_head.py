"""adaLN diffusion head, plain.

The benchmark's frozen copy of the port's `models/diffusion_head.py`
(reference `modular_vibevoice_diffusion_head.py:191-280`) for plain weights:
latent -> hidden projection, sinusoidal timestep embedding -> 2-layer SiLU
MLP, condition projection; N adaLN-modulated SwiGLU FFN blocks; final adaLN
linear back to the latent dim.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .configs import DiffusionHeadConfig
from .norms import rms_norm

Params = Dict[str, Any]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order (ref TimestepEmbedder :66-88)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return emb.to(t.dtype) if t.is_floating_point() else emb


def _swiglu(h: torch.Tensor, lp: Params) -> torch.Tensor:
    return F.silu(_mm(h, lp["gate"])) * _mm(h, lp["up"])


def precompute_modulations(params: Params, cfg: DiffusionHeadConfig,
                           condition: torch.Tensor,
                           timesteps: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """condition [N, H], timesteps [S] -> per-layer mods [S, N, 3H] and the
    final mod [S, N, 2H], all in one batched matmul per layer."""
    t_freq = timestep_embedding(timesteps.to(condition.dtype), cfg.freq_embed_size)
    t_emb = F.silu(t_freq.to(condition.dtype) @ params["t_mlp1"]) @ params["t_mlp2"]
    c = condition @ params["cond_proj"]                # [N, H]
    silu_c = F.silu(c[None, :, :] + t_emb[:, None, :])  # [S, N, H]
    layer_mods = [_mm(silu_c, lp["ada_w"]) for lp in params["layers"]]
    final_mod = _mm(silu_c, params["final_ada_w"])
    return layer_mods, final_mod


def apply_with_modulations(params: Params, cfg: DiffusionHeadConfig,
                           noisy: torch.Tensor, layer_mods, final_mod) -> torch.Tensor:
    """Denoise step with precomputed modulations ([N, 3H] each)."""
    eps = cfg.rms_norm_eps
    x = noisy @ params["noisy_proj"]
    for lp, mod in zip(params["layers"], layer_mods):
        shift, scale, gate = torch.chunk(mod, 3, dim=-1)
        h = rms_norm(x, lp["norm_w"], eps) * (1 + scale) + shift
        ffn = _mm(_swiglu(h, lp), lp["down"])
        x = x + gate * ffn
    shift, scale = torch.chunk(final_mod, 2, dim=-1)
    x = rms_norm(x, None, eps) * (1 + scale) + shift
    return x @ params["final_linear"]


__all__ = ["timestep_embedding", "precompute_modulations", "apply_with_modulations"]
