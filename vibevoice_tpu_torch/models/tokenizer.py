"""sigma-VAE acoustic / semantic tokenizers, plain (unfused) paths.

Port of `vibevoice_tpu/models/tokenizer.py` (reference codec stack
`modular_vibevoice_tokenizer.py:620-1186`), channel-last `[B, T, C]`:

* Encoder: stem conv + strided downsampling convs interleaved with stages of
  `Block1D` (depthwise-conv mixer + GELU FFN + layer-scale), head conv to the
  latent dim.
* Decoder: the mirror, upsampling with transposed convs (matmul + overlap-add).
* Streaming: every conv carries a fixed-shape state, collected in one flat
  list in the order the apply functions consume them (`*_state_init`).
* Quantized weights (`utils.quantize.quantize_tokenizer_stack`): the FFNs go
  through `quantize.mm`, the transition convs take their int8 paths.
* Fused streaming (`*_apply_streaming_fused`): the small-T stages (T <= 8
  frames per 7.5 Hz frame) run as ONE chain-kernel call per stage
  (`ops.fused_blocks`: int4 packs from `pack_*_stages(quant="int4")`, plain
  bf16/fp32 packs from `pack_*_stages()`), and the large-T stages
  (`large_packs` from `pack_*_stages_large`) as ONE fused stage-kernel call
  each (`ops.fused_stage`), optionally with the transition conv in front and
  the decoder tail folded into the same call.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..configs import AcousticTokenizerConfig
from ..ops.conv import (
    ConvState,
    ConvTState,
    causal_conv1d,
    causal_conv1d_streaming,
    causal_conv_transpose1d,
    causal_conv_transpose1d_streaming,
    conv_state_init,
    conv_transpose_state_init,
)
from ..ops import fused_blocks as fb
from ..ops import fused_stage as fs
from ..utils.quantize import mm
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

def _linear(h: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """Plain, int8 or int4 FFN weight (`quantize.mm`)."""
    h = mm(h, p["w"])
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


def _stage(params: Params, cfg, i: int, h: torch.Tensor, states: Optional[list],
           fused_packs=None, large_packs=None, tile_want: int = 400) -> torch.Tensor:
    """Stage i's Block1D chain: through the chain kernel when it has a pack
    in `fused_packs` (int4 or plain; every batch row in one call), through the
    large-T stage kernel when it has one in `large_packs` (streaming only),
    else block by block; threads the streaming states either way."""
    blocks = params["stages"][i]
    n = len(blocks)
    if fused_packs and i in fused_packs:
        packed = fused_packs[i]
        run = fb.fused_block_chain_batched if "w1q" in packed else fb.fused_block_chain_plain
        ctx = torch.stack([states.pop(0).buf for _ in range(n)], dim=1)  # [B, N, 6, D]
        h, new_ctx = run(packed, h.contiguous(), ctx.contiguous(), eps=cfg.layernorm_eps)
        states.extend(ConvState(buf=new_ctx[:, j]) for j in range(n))
        return h
    if large_packs and i in large_packs:
        return _large_stage(params, cfg, i, h, states, large_packs[i], tile_want)
    for bp in blocks:
        h = _block_apply(bp, h, cfg.layernorm_eps, _groups_of(cfg, h.shape[-1]), states)
    return h


def _large_stage(params: Params, cfg, i: int, h: torch.Tensor, states: list, packed,
                 tile_want: int, conv_st=None) -> torch.Tensor:
    """Stage i as ONE stage-kernel call, with the transition conv in front
    when `conv_st` (its state, popped already) is given and the decoder tail
    when the pack has a head: pops the N block states (and the head's) and
    appends the successors in the order [conv, blocks, head]."""
    n = len(params["stages"][i])
    ctx = torch.stack([states.pop(0).buf for _ in range(n)], dim=1)  # [B, N, 6, D]
    kw = {}
    head_st = None
    if packed.get("head") is not None:
        head_st = states.pop(0)
        kw["head_state"] = head_st.buf
    transposed = isinstance(conv_st, ConvTState)
    if conv_st is not None:
        kw["conv_state"] = conv_st.tail if transposed else conv_st.buf
    res = list(fs.fused_stage_chain(packed, h, ctx, eps=cfg.layernorm_eps,
                                    tile_want=tile_want, **kw))
    if conv_st is not None:
        new_c = res.pop(2).to(kw["conv_state"].dtype)
        states.append(ConvTState(tail=new_c) if transposed else ConvState(buf=new_c))
    states.extend(ConvState(buf=res[1][:, j]) for j in range(n))
    if head_st is not None:
        states.append(ConvState(buf=res[2].to(head_st.buf.dtype)))
    return res[0]


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
# fused streaming (chain kernels for the small-T stages, stage kernel for the large-T)
# ---------------------------------------------------------------------------

def _stage_pack(blocks, quant: Optional[str]):
    if quant == "int4":
        return fb.pack_stage_q(blocks)
    return fb.pack_stage(blocks, dtype=blocks[0]["ffn1"]["w"].dtype)


def pack_decoder_stages(params: Params, cfg: AcousticTokenizerConfig,
                        max_frames: int = 8, quant: Optional[str] = None):
    """Chain-kernel packs of the decoder stages whose per-frame T =
    prod(ratios[:i]) is at most `max_frames` ({stage index: pack}): plain
    packs in the weights' dtype (`ops.fused_blocks.pack_stage`), or with
    quant="int4" nibble-packed FFN weights (`ops.fused_blocks.pack_stage_q`)."""
    depths = cfg.decoder_depths_resolved()
    strides = list(cfg.decoder_ratios)
    packs = {}
    t = 1
    for i in range(len(depths)):
        if i > 0:
            t *= strides[i - 1]
        if t <= max_frames and depths[i] > 0:
            packs[i] = _stage_pack(params["stages"][i], quant)
    return packs


def pack_encoder_stages(params: Params, cfg, chunk_t: int, max_frames: int = 8,
                        quant: Optional[str] = None):
    """Mirror of `pack_decoder_stages` for the semantic re-encode: encoder
    stage i runs at T = chunk_t / prod(strides[:i+1])."""
    if cfg.mixer_layer != "depthwise_conv":
        return {}  # the kernel packs depthwise taps only
    depths = cfg.encoder_depths
    strides = [1] + list(reversed(cfg.encoder_ratios))
    packs = {}
    t = chunk_t
    for i in range(len(depths)):
        if t % strides[i]:
            raise ValueError(f"chunk {chunk_t} does not stream-divide encoder strides")
        t //= strides[i]
        if t <= max_frames and depths[i] > 0:
            packs[i] = _stage_pack(params["stages"][i], quant)
    return packs


def _large_stage_pack(params: Params, i: int, rowlane_batch: int):
    """The plain stage pack of stage i in its weights' dtype, or None when its
    FFNs are quantized or live in an int4 chain pack already (w None); with a
    row-lane pack for `rowlane_batch` rows when the row group is > 1 (added
    later only if no conv is folded)."""
    blocks = params["stages"][i]
    if blocks[0]["ffn1"]["w"] is None or isinstance(blocks[0]["ffn1"]["w"], dict):
        return None, None
    dtype = blocks[0]["ffn1"]["w"].dtype
    d = blocks[0]["norm_w"].shape[0]
    r = fs.rowlane_rows(d, rowlane_batch) if rowlane_batch else 1
    rowlane = fs.pack_stage_rowlane(blocks, r, dtype=dtype) if r > 1 else None
    return fs.pack_stage(blocks, dtype=dtype), rowlane


def pack_decoder_stages_large(params: Params, cfg: AcousticTokenizerConfig,
                              t_min: int = 128, fold_conv: bool = True,
                              fold_head: bool = True, rowlane_batch: int = 0):
    """Packs of the large-T stage kernel (`ops.fused_stage`) for the decoder
    stages whose per-frame T = prod(ratios[:i]) is at least t_min (and > 6),
    skipping stages with quantized FFNs.  `fold_conv` folds each such stage's
    transposed "up" conv (k = 2s, plain weight) into its call; `fold_head`
    folds the decoder tail (final norm + head conv D -> 1) into the last
    stage's; `rowlane_batch` adds row-lane packs to the stages without a
    folded conv (`ops.fused_stage.rowlane_rows`)."""
    if cfg.mixer_layer != "depthwise_conv":
        return {}
    depths = cfg.decoder_depths_resolved()
    strides = list(cfg.decoder_ratios)
    packs = {}
    t = 1
    for i in range(len(depths)):
        if i > 0:
            t *= strides[i - 1]
        if t < max(t_min, 7) or depths[i] == 0:
            continue
        pack, rowlane = _large_stage_pack(params, i, rowlane_batch)
        if pack is None:
            continue
        up = params["up"][i]
        if (fold_conv and i > 0 and not isinstance(up["w"], dict)
                and up["w"].shape[1] == 2 * strides[i - 1]):
            pack["conv"] = fs.pack_up_conv(up, strides[i - 1], dtype=pack["w1"].dtype)
        if rowlane is not None and "conv" not in pack:
            pack["rowlane"] = rowlane
        packs[i] = pack
    last = len(depths) - 1
    hw = params["head"]["w"]
    if (fold_head and last in packs and not isinstance(hw, dict)
            and hw.shape[2] == 1 and 0 < hw.shape[0] - 1 <= 8):
        packs[last]["head"] = fs.pack_head(params["head"], params["final_norm_w"])
    return packs


def pack_encoder_stages_large(params: Params, cfg, chunk_t: int, t_min: int = 128,
                              fold_conv: bool = True, rowlane_batch: int = 0):
    """Mirror of `pack_decoder_stages_large` for the semantic re-encode:
    encoder stage i runs at T = chunk_t / prod(strides[:i+1]); `fold_conv`
    folds the strided "down" conv in front (k = 2s, or the s = 1 stem)."""
    if cfg.mixer_layer != "depthwise_conv":
        return {}
    depths = cfg.encoder_depths
    strides = [1] + list(reversed(cfg.encoder_ratios))
    packs = {}
    t = chunk_t
    for i in range(len(depths)):
        t //= strides[i]
        if t < max(t_min, 7) or depths[i] == 0:
            continue
        pack, rowlane = _large_stage_pack(params, i, rowlane_batch)
        if pack is None:
            continue
        dp = params["down"][i]
        s_i, k_i = strides[i], (0 if isinstance(dp["w"], dict) else dp["w"].shape[0])
        if fold_conv and k_i and (s_i == 1 or k_i == 2 * s_i) and 0 < k_i - s_i <= 8:
            pack["conv"] = fs.pack_down_conv(dp, s_i, dtype=pack["w1"].dtype)
        if rowlane is not None and "conv" not in pack:
            pack["rowlane"] = rowlane
        packs[i] = pack
    return packs


def decoder_apply_streaming_fused(params: Params, cfg: AcousticTokenizerConfig,
                                  z: torch.Tensor, states, fused_packs=None,
                                  large_packs=None, tile_want: int = 400):
    """Streaming decode with the small-T stages on the chain kernels
    (`fused_packs`, int4 or plain) and the large-T stages on the stage kernel
    (`large_packs`); the same numerics as `decoder_apply_streaming` up to
    int4 weights and fp32 in-kernel rounding.  Returns (audio, new_states)."""
    depths = cfg.decoder_depths_resolved()
    strides = list(cfg.decoder_ratios)
    s = list(states)
    h = z
    large_packs = large_packs or {}
    for i in range(len(depths)):
        lp = large_packs.get(i)
        if lp is not None and "conv" in lp:
            h = _large_stage(params, cfg, i, h, s, lp, tile_want, conv_st=s.pop(0))
            continue
        up = params["up"][i]
        if i == 0:
            h = _conv(h, up, s)
        else:
            h, new_st = causal_conv_transpose1d_streaming(h, s.pop(0), up["w"], up["b"],
                                                          stride=strides[i - 1])
            s.append(new_st)
        h = _stage(params, cfg, i, h, s, fused_packs, large_packs, tile_want)
    last = large_packs.get(len(depths) - 1)
    if last is not None and "head" in last:
        return h, s  # the tail ran inside the last stage's call
    if params["final_norm_w"] is not None:
        h = rms_norm(h, params["final_norm_w"], cfg.layernorm_eps)
    return _conv(h, params["head"], s), s


def encoder_apply_streaming_fused(params: Params, cfg, x: torch.Tensor, states,
                                  fused_packs=None, large_packs=None, tile_want: int = 400):
    """Streaming encode, the mirror of `decoder_apply_streaming_fused`.
    Returns (latents, new_states)."""
    strides = [1] + list(reversed(cfg.encoder_ratios))
    s = list(states)
    h = x
    large_packs = large_packs or {}
    for i in range(len(cfg.encoder_depths)):
        lp = large_packs.get(i)
        if lp is not None and "conv" in lp:
            h = _large_stage(params, cfg, i, h, s, lp, tile_want, conv_st=s.pop(0))
            continue
        h = _conv(h, params["down"][i], s, stride=strides[i])
        h = _stage(params, cfg, i, h, s, fused_packs, large_packs, tile_want)
    if params["final_norm_w"] is not None:
        h = rms_norm(h, params["final_norm_w"], cfg.layernorm_eps)
    return _conv(h, params["head"], s), s


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
    "encoder_apply_streaming_fused",
    "decoder_apply_streaming_fused",
    "pack_decoder_stages",
    "pack_encoder_stages",
    "pack_decoder_stages_large",
    "pack_encoder_stages_large",
    "encoder_state_init",
    "decoder_state_init",
    "state_reset_where",
    "vae_sample_gaussian",
    "vae_sample_fix",
    "encoder_dims",
    "decoder_dims",
]
