"""adaLN diffusion head.

Port of `vibevoice_tpu/models/diffusion_head.py` (reference
`modular_vibevoice_diffusion_head.py:191-280`): latent -> hidden projection,
sinusoidal timestep embedding -> 2-layer SiLU MLP, condition projection; N
adaLN-modulated SwiGLU FFN blocks; final adaLN linear back to the latent dim.
The adaLN modulations of every solver step are computed once per frame
(`precompute_modulations`), so each step runs only the projection, the FFNs
and the final linear.  The FFN and adaLN weights may be quantized
(`utils.quantize.mm`); the int4 layout fuses gate|up into `gateup`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DiffusionHeadConfig
from ..utils.quantize import mm
from .norms import rms_norm

Params = Dict[str, Any]


def init(cfg: DiffusionHeadConfig, dtype=torch.float32, device="cpu",
         generator: Optional[torch.Generator] = None) -> Params:
    """Init matching the reference: t-embedder and projections ~ N(0, 0.02);
    adaLN modulation and final linear zero."""
    h, lat, ffn = cfg.hidden_size, cfg.latent_size, int(cfg.hidden_size * cfg.head_ffn_ratio)

    def nrm(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = [{
        "ada_w": zeros((h, 3 * h)),
        "norm_w": torch.ones(h, dtype=dtype, device=device),
        "gate": nrm((h, ffn)),
        "up": nrm((h, ffn)),
        "down": nrm((ffn, h)),
    } for _ in range(cfg.head_layers)]
    return {
        "noisy_proj": nrm((lat, h)),
        "cond_proj": nrm((h, h)),
        "t_mlp1": nrm((cfg.freq_embed_size, h)),
        "t_mlp2": nrm((h, h)),
        "layers": layers,
        "final_ada_w": zeros((h, 2 * h)),
        "final_linear": zeros((h, lat)),
    }


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order (ref TimestepEmbedder :66-88)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return emb.to(t.dtype) if t.is_floating_point() else emb


def _swiglu(h: torch.Tensor, lp: Params) -> torch.Tensor:
    if "gateup" in lp:
        gu = mm(h, lp["gateup"])
        ffn = gu.shape[-1] // 2
        return F.silu(gu[..., :ffn]) * gu[..., ffn:]
    return F.silu(mm(h, lp["gate"])) * mm(h, lp["up"])


def precompute_modulations(params: Params, cfg: DiffusionHeadConfig,
                           condition: torch.Tensor,
                           timesteps: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """condition [N, H], timesteps [S] -> per-layer mods [S, N, 3H] and the
    final mod [S, N, 2H], all in one batched matmul per layer."""
    t_freq = timestep_embedding(timesteps.to(condition.dtype), cfg.freq_embed_size)
    t_emb = F.silu(t_freq.to(condition.dtype) @ params["t_mlp1"]) @ params["t_mlp2"]
    c = condition @ params["cond_proj"]                # [N, H]
    silu_c = F.silu(c[None, :, :] + t_emb[:, None, :])  # [S, N, H]
    layer_mods = [mm(silu_c, lp["ada_w"]) for lp in params["layers"]]
    final_mod = mm(silu_c, params["final_ada_w"])
    return layer_mods, final_mod


def apply_with_modulations(params: Params, cfg: DiffusionHeadConfig,
                           noisy: torch.Tensor, layer_mods, final_mod) -> torch.Tensor:
    """Denoise step with precomputed modulations ([N, 3H] each)."""
    eps = cfg.rms_norm_eps
    x = noisy @ params["noisy_proj"]
    for lp, mod in zip(params["layers"], layer_mods):
        shift, scale, gate = torch.chunk(mod, 3, dim=-1)
        h = rms_norm(x, lp["norm_w"], eps) * (1 + scale) + shift
        x = x + gate * mm(_swiglu(h, lp), lp["down"])
    shift, scale = torch.chunk(final_mod, 2, dim=-1)
    x = rms_norm(x, None, eps) * (1 + scale) + shift
    return x @ params["final_linear"]


__all__ = ["init", "timestep_embedding", "precompute_modulations", "apply_with_modulations"]
