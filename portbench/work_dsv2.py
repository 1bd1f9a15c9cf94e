"""The yardstick's arithmetic for a VibeVoice whose LM is DeepSeek-V2: the
operations and bytes of the latent-attention decode call and of one whole
decode step, counted from the configuration's shapes and stated precision
(`work.py`'s rules: each input read once, each output written once,
2 operations per multiply-add), never from what the port launches.

Two counts are not `work.step_work`'s: the experts a step must read are those
its rows were routed to (the program's own tally, `moe.experts_hit`, per
layer), and the diffusion head's FFN weights are read at each solver step
(they do not stay in L2 between the solver's steps).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .work import _tokenizer_params, decoder_frame_flops, encoder_frame_flops


def mla_decode_work(heads: int, width: int, v_width: int, visible: Sequence[int],
                    lengths: Sequence[int], elem: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one layer's absorbed latent-attention decode for
    rows that each see `visible[r]` cached slots among their first
    `lengths[r]`: q in [heads, width] and the output back [heads, v_width]
    per row, each visible slot's latent once for all heads, the visibility
    mask up to each row's length (int32) and the lengths."""
    rows = len(visible)
    qo = rows * heads * (width + v_width) * elem
    slots = sum(visible) * width * elem
    mask = 4 * sum(lengths) + 4 * rows
    flops = 2 * sum(visible) * heads * (width + v_width)
    return float(flops), float(qo + slots + mask)


def step_work(cfg, batch: int, visible_pos: Sequence[int], visible_neg: Sequence[int],
              ddpm_steps: int, experts_hit: float, elem: int = 2) -> Dict[str, float]:
    """Operations and bytes of one decode step of `batch` rows (each a
    positive and a CFG-negative stream) whose streams see the given numbers
    of cached slots (the new slot included), with `experts_hit` distinct
    experts read per expert layer, by part:
      lm         its weights once (the experts hit only), the visible latent
                 slots once and the new ones written; the projections, the
                 absorbed attention, the dense FFN, the router, the shared
                 experts and each row's top-k experts for 2B rows; the logits
                 over the allowed tokens;
      head       its weights, the FFN's at every solver step; the modulations
                 and the denoiser on both CFG streams at every solver step;
      sigma_vae  the decoder's and the semantic encoder's weights once, their
                 operations over one frame's samples per row;
      connectors both, per row."""
    dec, dh = cfg.decoder, cfg.diffusion_head
    h, L, nh = dec.hidden_size, dec.num_hidden_layers, dec.num_attention_heads
    r, rope, nope, v = dec.kv_lora_rank, dec.qk_rope_head_dim, dec.qk_nope_head_dim, \
        dec.v_head_dim
    width = r + rope
    rows = 2 * batch
    moe_layers = sum(dec.is_moe(li) for li in range(L))
    attn_w = h * nh * (nope + rope) + h * width + r * nh * (nope + v) + nh * v * h
    dense_w = 3 * h * dec.intermediate_size
    expert_w = 3 * h * dec.moe_intermediate_size
    shared_w = expert_w * dec.n_shared_experts
    router_w = h * dec.n_routed_experts
    lm_w_bytes = (L * attn_w + (L - moe_layers) * dense_w
                  + moe_layers * (router_w + shared_w + experts_hit * expert_w)) * elem
    vis = list(visible_pos) + list(visible_neg)
    per_token = (L * (h * nh * (nope + rope) + h * width + nh * v * h)
                 + (L - moe_layers) * dense_w
                 + moe_layers * (router_w + shared_w + dec.num_experts_per_tok * expert_w))
    absorb = L * nh * (nope * r + r * v)  # q_nope into the latent, the latent out to v
    attn = 2 * sum(vis) * L * nh * (width + r)
    lm = {"flops": 2 * rows * (per_token + absorb) + attn + 2 * batch * h * 5,
          "bytes": lm_w_bytes + (sum(vis) + rows) * L * width * elem}
    hh, lat, hf, S = dh.hidden_size, dh.latent_size, int(dh.hidden_size * dh.head_ffn_ratio), \
        ddpm_steps
    layers = dh.head_layers
    ffn_w = layers * 3 * hh * hf
    head_w = (lat * hh + hh * hh + dh.freq_embed_size * hh + hh * hh
              + layers * 3 * hh * hh + 2 * hh * hh + hh * lat)
    n = rows  # the head runs on [cond; neg]
    mods = 2 * n * hh * hh + 2 * S * (dh.freq_embed_size * hh + hh * hh) \
        + 2 * S * n * hh * (layers * 3 * hh + 2 * hh)
    denoise = 2 * S * n * (lat * hh + layers * 3 * hh * hf + hh * lat)
    head = {"flops": mods + denoise, "bytes": (head_w + S * ffn_w) * elem}
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


__all__ = ["mla_decode_work", "step_work"]
