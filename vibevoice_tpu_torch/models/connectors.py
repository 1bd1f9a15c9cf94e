"""SpeechConnector: latent -> LM hidden projection (ref modeling_vibevoice.py:58-69).

Port of `vibevoice_tpu/models/connectors.py`: Linear -> RMSNorm(eps=1e-6) ->
Linear, biases on both linears.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .norms import rms_norm

Params = Dict[str, Any]


def init(input_dim: int, output_dim: int, dtype=torch.float32, *, device,
         generator: Optional[torch.Generator] = None, std: float = 0.02) -> Params:
    def nrm(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * std).to(dtype)

    return {
        "fc1": {"w": nrm((input_dim, output_dim)),
                "b": torch.zeros(output_dim, dtype=dtype, device=device)},
        "norm_w": torch.ones(output_dim, dtype=dtype, device=device),
        "fc2": {"w": nrm((output_dim, output_dim)),
                "b": torch.zeros(output_dim, dtype=dtype, device=device)},
    }


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["fc1"]["w"] + params["fc1"]["b"]
    h = rms_norm(h, params["norm_w"], 1e-6)
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


__all__ = ["init", "apply"]
