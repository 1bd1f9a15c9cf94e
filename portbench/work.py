"""The yardstick's arithmetic: the chip's peaks, the least time of a piece of
work, and the operations and bytes of the decode-attention call and of one
whole decode step, counted from the configuration's shapes and stated
precision, never from what the port launches.

Bytes count each input read once and each output written once, whatever an
implementation reads again; operations count 2 per multiply-add.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM (the data sheet's dense rates at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The larger of the operations over the bf16 peak and the bytes over
    HBM's rate, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_attention_work(heads: int, head_dim: int, kv_heads: int, visible: Sequence[int],
                          lengths: Sequence[int], elem: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one layer's decode attention for rows that
    each see `visible[r]` cached slots among their first `lengths[r]`: q in
    and the output back, each visible slot's k and v, the visibility mask up
    to each row's length (int32) and the lengths."""
    rows = len(visible)
    qo = 2 * rows * heads * head_dim * elem
    kv = 2 * sum(visible) * kv_heads * head_dim * elem
    mask = 4 * sum(lengths) + 4 * rows
    flops = 4 * sum(visible) * heads * head_dim  # q.k and p.v per visible slot and head
    return float(flops), float(qo + kv + mask)


def _conv_flops(t_out: int, k: int, cin: int, cout: int, groups: int = 1) -> int:
    return 2 * t_out * k * (cin // groups) * cout


def _blocks_flops(t: int, dim: int, depth: int, ffn_expansion: int) -> int:
    per = 2 * t * 7 * dim + 2 * 2 * t * dim * ffn_expansion * dim  # depthwise mixer + FFN
    return depth * per


def decoder_frame_flops(ac) -> int:
    """The sigma-VAE decoder's operations for one latent frame (hop samples)."""
    depths = ac.decoder_depths_resolved()
    n = len(depths)
    dims = [ac.decoder_n_filters * 2 ** (n - 1 - i) for i in range(n)]
    t, flops = 1, _conv_flops(1, ac.kernel_size, ac.vae_dim, dims[0])
    for i in range(n):
        if i:
            r = ac.decoder_ratios[i - 1]
            flops += 2 * t * dims[i - 1] * 2 * r * dims[i]  # transposed conv's projection
            t *= r
        flops += _blocks_flops(t, dims[i], depths[i], ac.ffn_expansion)
    return flops + _conv_flops(t, ac.last_kernel_size, dims[-1], ac.channels)


def encoder_frame_flops(ec) -> int:
    """An encoder's operations for one frame's hop samples."""
    depths = ec.encoder_depths
    n = len(depths)
    dims = [ec.encoder_n_filters * 2 ** i for i in range(n)]
    strides = list(reversed(ec.encoder_ratios))
    t = 1
    for s in strides:
        t *= s
    flops = _conv_flops(t, ec.kernel_size, ec.channels, dims[0])
    for i in range(n):
        if i:
            t //= strides[i - 1]
            flops += _conv_flops(t, 2 * strides[i - 1], dims[i - 1], dims[i])
        flops += _blocks_flops(t, dims[i], depths[i], ec.ffn_expansion)
    return flops + _conv_flops(t, ec.last_kernel_size, dims[-1], ec.vae_dim)


def step_work(cfg, batch: int, visible_pos: Sequence[int], visible_neg: Sequence[int],
              ddpm_steps: int, elem: int = 2) -> Dict[str, float]:
    """Operations and bytes of one decode step of `batch` rows (each a
    positive and a CFG-negative stream) whose streams see the given numbers
    of cached slots (the new slot included), by part:
      lm         the weights once and the live KV once; q/k/v/o and the MLP
                 for 2B rows, attention over the visible slots, the logits
                 over the allowed tokens;
      head       its weights once; the modulations of every solver step and
                 the denoiser on both CFG streams at every solver step;
      sigma_vae  the decoder's and the semantic encoder's weights once, their
                 operations over one frame's samples per row;
      connectors both, per row."""
    dec, dh = cfg.decoder, cfg.diffusion_head
    h, f, L = dec.hidden_size, dec.intermediate_size, dec.num_hidden_layers
    hd, nh, nkv = dec.head_dim, dec.num_attention_heads, dec.num_key_value_heads
    rows = 2 * batch
    lm_w = L * (h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * f)
    vis = list(visible_pos) + list(visible_neg)
    kv_bytes = 2 * sum(vis) * L * nkv * hd * elem
    lm = {"flops": 2 * rows * lm_w + 4 * sum(vis) * L * nh * hd + 2 * batch * h * 5,
          "bytes": lm_w * elem + kv_bytes + rows * L * 2 * nkv * hd * elem}
    hh, lat, hf, S = dh.hidden_size, dh.latent_size, int(dh.hidden_size * dh.head_ffn_ratio), \
        ddpm_steps
    layers = dh.head_layers
    head_w = (lat * hh + hh * hh + dh.freq_embed_size * hh + hh * hh
              + layers * (3 * hh * hh + 3 * hh * hf) + 2 * hh * hh + hh * lat)
    n = rows  # the head runs on [cond; neg]
    mods = 2 * n * hh * hh + 2 * S * (dh.freq_embed_size * hh + hh * hh) \
        + 2 * S * n * hh * (layers * 3 * hh + 2 * hh)
    denoise = 2 * S * n * (lat * hh + layers * 3 * hh * hf + hh * lat)
    head = {"flops": mods + denoise, "bytes": head_w * elem}
    ac, se = cfg.acoustic_tokenizer, cfg.semantic_tokenizer
    vae_w = _tokenizer_params(ac, decoder=True) + _tokenizer_params(se, decoder=False)
    vae = {"flops": batch * (decoder_frame_flops(ac) + encoder_frame_flops(se)),
           "bytes": vae_w * elem}
    conn_w = (cfg.acoustic_vae_dim * h + h * h) + (cfg.semantic_vae_dim * h + h * h)
    conn = {"flops": 2 * batch * conn_w, "bytes": conn_w * elem}
    parts = {"lm": lm, "head": head, "sigma_vae": vae, "connectors": conn}
    return {"flops": float(sum(p["flops"] for p in parts.values())),
            "bytes": float(sum(p["bytes"] for p in parts.values())),
            **{f"{k}_{q}": float(v[q]) for k, v in parts.items() for q in ("flops", "bytes")}}


def _tokenizer_params(c, decoder: bool) -> int:
    """Weights of a decoder (or an encoder) stack: convs, blocks, head."""
    if decoder:
        depths = c.decoder_depths_resolved()
        n = len(depths)
        dims = [c.decoder_n_filters * 2 ** (n - 1 - i) for i in range(n)]
        convs = c.kernel_size * c.vae_dim * dims[0] + sum(
            dims[i] * 2 * c.decoder_ratios[i] * dims[i + 1] for i in range(n - 1))
        head = c.last_kernel_size * dims[-1] * c.channels
    else:
        depths = c.encoder_depths
        n = len(depths)
        dims = [c.encoder_n_filters * 2 ** i for i in range(n)]
        strides = list(reversed(c.encoder_ratios))
        convs = c.kernel_size * c.channels * dims[0] + sum(
            2 * strides[i] * dims[i] * dims[i + 1] for i in range(n - 1))
        head = c.last_kernel_size * dims[-1] * c.vae_dim
    e = c.ffn_expansion
    # mixer, FFN, their biases, two norms and two layer scales
    blocks = sum(depths[i] * (7 * dims[i] + 2 * e * dims[i] ** 2 + (e + 2) * dims[i]
                              + 4 * dims[i]) for i in range(n))
    biases = sum(dims) + (c.channels if decoder else c.vae_dim)
    return convs + blocks + head + biases


__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES_PER_S", "least_seconds",
           "decode_attention_work", "decoder_frame_flops", "encoder_frame_flops", "step_work"]
