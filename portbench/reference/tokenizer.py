"""sigma-VAE tokenizer stacks, plain.

The benchmark's frozen copy of the port's `models/tokenizer.py` (reference
`modular_vibevoice_tokenizer.py`: TokenizerEncoder :687, TokenizerDecoder
:816, Block1D :620) without the packed kernel paths: stem conv + strided
down convs (encoder) or transposed up convs (decoder), each followed by a
chain of Block1D (depthwise-conv mixer with layer scale, GELU FFN with layer
scale).  The streaming states are flat lists in the order the stacks consume
them, as in the port, so a step can start from the program's own state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from .configs import AcousticTokenizerConfig
from .conv import (
    causal_conv1d,
    causal_conv1d_streaming,
    causal_conv_transpose1d,
    causal_conv_transpose1d_streaming,
    conv_state_init,
    conv_transpose_state_init,
)
from .norms import rms_norm

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# stage widths
# ---------------------------------------------------------------------------

def encoder_dims(n_filters: int, n_stages: int) -> List[int]:
    return [n_filters * (2 ** i) for i in range(n_stages)]


def decoder_dims(n_filters: int, n_stages: int) -> List[int]:
    return [n_filters * (2 ** (n_stages - 1 - i)) for i in range(n_stages)]


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _linear(h: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    h = h @ p["w"]
    return h if p["b"] is None else h + p["b"]


def _conv(h, p, states: Optional[list], stride: int = 1, groups: int = 1):
    """One causal conv, streaming when `states` is given (pop the next state,
    append its successor)."""
    if states is None:
        return causal_conv1d(h, p["w"], p["b"], stride=stride, groups=groups)
    h, new_st = causal_conv1d_streaming(h, states.pop(0), p["w"], p["b"],
                                        stride=stride, groups=groups)
    states.append(new_st)
    return h


def _block_apply(p: Params, x: torch.Tensor, eps: float, groups: int,
                 states: Optional[list] = None) -> torch.Tensor:
    """Block1D forward (ref :665-684): mixer + layer-scale, then GELU FFN."""
    h = _conv(rms_norm(x, p["norm_w"], eps), p["mixer"], states, groups=groups)
    x = x + h * p["gamma"]
    h = rms_norm(x, p["ffn_norm_w"], eps)
    h = F.gelu(_linear(h, p["ffn1"]), approximate="none")
    return x + _linear(h, p["ffn2"]) * p["ffn_gamma"]


def _groups_of(cfg, dim: int) -> int:
    return dim if cfg.mixer_layer == "depthwise_conv" else 1


def _stage(params: Params, cfg, i: int, h: torch.Tensor, states: Optional[list]) -> torch.Tensor:
    """Stage i's Block1D chain, block by block, threading the streaming states."""
    for bp in params["stages"][i]:
        h = _block_apply(bp, h, cfg.layernorm_eps, _groups_of(cfg, h.shape[-1]), states)
    return h


def encoder_apply(params: Params, cfg, x: torch.Tensor,
                  states: Optional[list] = None) -> torch.Tensor:
    """audio [B, T, 1] -> latents [B, T/hop, vae_dim] (ref forward :810-813).
    With `states` (from `encoder_state_init`) it runs one streaming chunk and
    rotates the list in place."""
    strides = [1] + list(reversed(cfg.encoder_ratios))
    h = x
    for i in range(len(cfg.encoder_depths)):
        h = _conv(h, params["down"][i], states, stride=strides[i])
        h = _stage(params, cfg, i, h, states)
    if params["final_norm_w"] is not None:
        h = rms_norm(h, params["final_norm_w"], cfg.layernorm_eps)
    return _conv(h, params["head"], states)


def decoder_apply(params: Params, cfg: AcousticTokenizerConfig, z: torch.Tensor,
                  states: Optional[list] = None) -> torch.Tensor:
    """latents [B, F, vae_dim] -> audio [B, F*hop, 1] (ref forward :948-951);
    streaming as in `encoder_apply`."""
    strides = list(cfg.decoder_ratios)
    h = z
    for i in range(len(cfg.decoder_depths_resolved())):
        up = params["up"][i]
        if i == 0:
            h = _conv(h, up, states)
        elif states is None:
            h = causal_conv_transpose1d(h, up["w"], up["b"], stride=strides[i - 1])
        else:
            h, new_st = causal_conv_transpose1d_streaming(h, states.pop(0), up["w"], up["b"],
                                                          stride=strides[i - 1])
            states.append(new_st)
        h = _stage(params, cfg, i, h, states)
    if params["final_norm_w"] is not None:
        h = rms_norm(h, params["final_norm_w"], cfg.layernorm_eps)
    return _conv(h, params["head"], states)


def encoder_apply_streaming(params: Params, cfg, x: torch.Tensor, states):
    """Functional streaming encode: returns (latents, new_states)."""
    s = list(states)
    return encoder_apply(params, cfg, x, s), s


def decoder_apply_streaming(params: Params, cfg, z: torch.Tensor, states):
    """Functional streaming decode: returns (audio, new_states)."""
    s = list(states)
    return decoder_apply(params, cfg, z, s), s


# ---------------------------------------------------------------------------
# streaming state
# ---------------------------------------------------------------------------

def encoder_state_init(cfg, batch: int, dtype=torch.float32, device="cpu") -> list:
    """Flat list of ConvState in the exact order `encoder_apply` consumes them."""
    depths = cfg.encoder_depths
    n = len(depths)
    dims = encoder_dims(cfg.encoder_n_filters, n)
    strides = [1] + list(reversed(cfg.encoder_ratios))
    states: list = []
    cin = cfg.channels
    for i in range(n):
        k = cfg.kernel_size if i == 0 else 2 * strides[i]
        states.append(conv_state_init(batch, cin, k, strides[i], dtype=dtype, device=device))
        cin = dims[i]
        for _ in range(depths[i]):
            states.append(conv_state_init(batch, dims[i], 7, 1, dtype=dtype, device=device))
    states.append(conv_state_init(batch, dims[-1], cfg.last_kernel_size, 1, dtype=dtype,
                                  device=device))
    return states


def decoder_state_init(cfg: AcousticTokenizerConfig, batch: int, dtype=torch.float32,
                       device="cpu") -> list:
    depths = cfg.decoder_depths_resolved()
    n = len(depths)
    dims = decoder_dims(cfg.decoder_n_filters, n)
    strides = list(cfg.decoder_ratios)
    states: list = []
    for i in range(n):
        if i == 0:
            states.append(conv_state_init(batch, cfg.vae_dim, cfg.kernel_size, 1,
                                          dtype=dtype, device=device))
        else:
            r = strides[i - 1]
            states.append(conv_transpose_state_init(batch, dims[i], 2 * r, r,
                                                    dtype=dtype, device=device))
        for _ in range(depths[i]):
            states.append(conv_state_init(batch, dims[i], 7, 1, dtype=dtype, device=device))
    states.append(conv_state_init(batch, dims[-1], cfg.last_kernel_size, 1, dtype=dtype,
                                  device=device))
    return states


__all__ = [
    "encoder_apply",
    "decoder_apply",
    "encoder_apply_streaming",
    "decoder_apply_streaming",
    "encoder_state_init",
    "decoder_state_init",
    "encoder_dims",
    "decoder_dims",
]
