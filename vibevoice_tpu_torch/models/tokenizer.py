"""sigma-VAE acoustic / semantic tokenizers, plain (unfused) paths.

Port of `vibevoice_tpu/models/tokenizer.py` (reference codec stack
`modular_vibevoice_tokenizer.py:620-1186`), channel-last `[B, T, C]`:

* Encoder: stem conv + strided downsampling convs interleaved with stages of
  `Block1D` (depthwise-conv mixer + GELU FFN + layer-scale), head conv to the
  latent dim.
* Decoder: the mirror, upsampling with transposed convs (matmul + overlap-add).
* Streaming: every conv carries a fixed-shape state, collected in one flat
  list in the order the apply functions consume them (`*_state_init`).

The fused stage kernels (`pack_*`, `*_fused`) are later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..configs import AcousticTokenizerConfig
from ..ops.conv import (
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
# init (reference _init_weights :1067-1079: N(0, weight_init_value), zero bias)
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, dtype, device, generator):
        self.dtype, self.device, self.generator = dtype, device, generator

    def normal(self, shape, std: float) -> torch.Tensor:
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return (w * std).to(self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def layer(self, shape, cout: int, std: float, bias: bool) -> Dict[str, Any]:
        return {"w": self.normal(shape, std),
                "b": self.full((cout,), 0.0) if bias else None}


def _block_init(it: _Init, dim: int, cfg) -> Params:
    """Block1D params (ref :620-684)."""
    groups = dim if cfg.mixer_layer == "depthwise_conv" else 1
    std, bias, ffn = cfg.weight_init_value, cfg.conv_bias, cfg.ffn_expansion * dim
    return {
        "norm_w": it.full((dim,), 1.0),
        "mixer": it.layer((7, dim // groups, dim), dim, std, bias),
        "gamma": it.full((dim,), cfg.layer_scale_init_value),
        "ffn_norm_w": it.full((dim,), 1.0),
        "ffn1": it.layer((dim, ffn), ffn, std, bias),
        "ffn2": it.layer((ffn, dim), dim, std, bias),
        "ffn_gamma": it.full((dim,), cfg.layer_scale_init_value),
    }


def encoder_dims(n_filters: int, n_stages: int) -> List[int]:
    return [n_filters * (2 ** i) for i in range(n_stages)]


def decoder_dims(n_filters: int, n_stages: int) -> List[int]:
    return [n_filters * (2 ** (n_stages - 1 - i)) for i in range(n_stages)]


def init_encoder(cfg, dtype=torch.float32, device="cpu",
                 generator: Optional[torch.Generator] = None) -> Params:
    """TokenizerEncoder params (ref :687-774)."""
    it = _Init(dtype, device, generator)
    depths = cfg.encoder_depths
    n = len(depths)
    dims = encoder_dims(cfg.encoder_n_filters, n)
    strides = list(reversed(cfg.encoder_ratios))
    std, bias = cfg.weight_init_value, cfg.conv_bias
    down = [it.layer((cfg.kernel_size, cfg.channels, dims[0]), dims[0], std, bias)]
    for i in range(n - 1):
        down.append(it.layer((2 * strides[i], dims[i], dims[i + 1]), dims[i + 1], std, bias))
    stages = [[_block_init(it, dims[i], cfg) for _ in range(depths[i])] for i in range(n)]
    final_norm = None if cfg.disable_last_norm else it.full((dims[-1],), 1.0)
    head = it.layer((cfg.last_kernel_size, dims[-1], cfg.vae_dim), cfg.vae_dim, std, bias)
    return {"down": down, "stages": stages, "final_norm_w": final_norm, "head": head}


def init_decoder(cfg: AcousticTokenizerConfig, dtype=torch.float32, device="cpu",
                 generator: Optional[torch.Generator] = None) -> Params:
    """TokenizerDecoder params (ref :816-912)."""
    it = _Init(dtype, device, generator)
    depths = cfg.decoder_depths_resolved()
    n = len(depths)
    dims = decoder_dims(cfg.decoder_n_filters, n)
    strides = list(cfg.decoder_ratios)
    std, bias = cfg.weight_init_value, cfg.conv_bias
    up = [it.layer((cfg.kernel_size, cfg.vae_dim, dims[0]), dims[0], std, bias)]
    for i in range(n - 1):
        up.append(it.layer((dims[i], 2 * strides[i], dims[i + 1]), dims[i + 1], std, bias))
    stages = [[_block_init(it, dims[i], cfg) for _ in range(depths[i])] for i in range(n)]
    final_norm = None if cfg.disable_last_norm else it.full((dims[-1],), 1.0)
    head = it.layer((cfg.last_kernel_size, dims[-1], cfg.channels), cfg.channels, std, bias)
    return {"up": up, "stages": stages, "final_norm_w": final_norm, "head": head}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _plain_linear(h: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    if isinstance(p["w"], dict) or p["w"] is None:
        raise NotImplementedError("quantized tokenizer weights are not ported yet (ROADMAP A7)")
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
    h = F.gelu(_plain_linear(h, p["ffn1"]), approximate="none")
    return x + _plain_linear(h, p["ffn2"]) * p["ffn_gamma"]


def _groups_of(cfg, dim: int) -> int:
    return dim if cfg.mixer_layer == "depthwise_conv" else 1


def encoder_apply(params: Params, cfg, x: torch.Tensor,
                  states: Optional[list] = None) -> torch.Tensor:
    """audio [B, T, 1] -> latents [B, T/hop, vae_dim] (ref forward :810-813).
    With `states` (from `encoder_state_init`) it runs one streaming chunk and
    rotates the list in place."""
    strides = [1] + list(reversed(cfg.encoder_ratios))
    h = x
    for i in range(len(cfg.encoder_depths)):
        h = _conv(h, params["down"][i], states, stride=strides[i])
        for bp in params["stages"][i]:
            h = _block_apply(bp, h, cfg.layernorm_eps, _groups_of(cfg, h.shape[-1]), states)
    if params["final_norm_w"] is not None:
        h = rms_norm(h, params["final_norm_w"], cfg.layernorm_eps)
    return _conv(h, params["head"], states)


def decoder_apply(params: Params, cfg: AcousticTokenizerConfig, z: torch.Tensor,
                  states: Optional[list] = None) -> torch.Tensor:
    """latents [B, F, vae_dim] -> audio [B, F*hop, 1] (ref forward :948-951)."""
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
        for bp in params["stages"][i]:
            h = _block_apply(bp, h, cfg.layernorm_eps, _groups_of(cfg, h.shape[-1]), states)
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


def state_reset_where(states: list, reset_mask: torch.Tensor) -> list:
    """Zero the streaming state of samples where reset_mask[b] is True
    (the reference's `cache.set_to_zero(sample_indices)`, :234-241)."""
    def _z(leaf):
        m = reset_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, torch.zeros_like(leaf), leaf)
    return [type(st)(*(_z(leaf) for leaf in st)) for st in states]


# ---------------------------------------------------------------------------
# VAE sampling (ref VibeVoiceTokenizerEncoderOutput :954-1000)
# ---------------------------------------------------------------------------

def vae_sample_gaussian(generator: Optional[torch.Generator], mean: torch.Tensor,
                        fix_std: float) -> torch.Tensor:
    """'gaussian' sampling: a batch-wise random std scaled by fix_std/0.8."""
    b = mean.shape[0]
    std = torch.randn(b, generator=generator, dtype=mean.dtype, device=mean.device)
    std = (std * (fix_std / 0.8)).reshape((b,) + (1,) * (mean.dim() - 1))
    return mean + std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                    device=mean.device)


def vae_sample_fix(generator: Optional[torch.Generator], mean: torch.Tensor,
                   fix_std: float) -> torch.Tensor:
    return mean + fix_std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                        device=mean.device)


__all__ = [
    "init_encoder",
    "init_decoder",
    "encoder_apply",
    "decoder_apply",
    "encoder_apply_streaming",
    "decoder_apply_streaming",
    "encoder_state_init",
    "decoder_state_init",
    "state_reset_where",
    "vae_sample_gaussian",
    "vae_sample_fix",
    "encoder_dims",
    "decoder_dims",
]
