"""SpeechConnector: latent -> LM hidden projection (ref modeling_vibevoice.py:58-69).

The benchmark's frozen copy of the port's `models/connectors.py`: Linear -> RMSNorm(eps=1e-6) ->
Linear, biases on both linears.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .norms import rms_norm

Params = Dict[str, Any]


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["fc1"]["w"] + params["fc1"]["b"]
    h = rms_norm(h, params["norm_w"], 1e-6)
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


__all__ = ["apply"]
