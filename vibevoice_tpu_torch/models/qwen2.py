"""Qwen2 causal decoder over one stacked KV cache.

Port of `vibevoice_tpu/models/qwen2.py`: RoPE (theta 1e6), GQA, RMSNorm,
SwiGLU MLP, biased q/k/v projections, HF Qwen2 numerics.  Plain functions over
the same parameter dict as the JAX package (linear weights [in, out]).

The KV cache is one preallocated `[L, B, S, KVH*D]` pair, written in place at
one slot range per call (`write_pos`, a host int shared by every row, and
`batch_offset` rows).  With `decode_ctx=(visible, lengths)` a one-token decode
reads the cache through the split-K CUDA kernel `ops.decode_attention`; every
other call attends densely with an additive fp32 bias.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import Qwen2Config
from ..ops.decode_attention import decode_attention
from .norms import rms_norm

Params = Dict[str, Any]


def _normal(generator, shape, std, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            * std).to(dtype)


def init(cfg: Qwen2Config, dtype=torch.float32, device="cpu",
         generator: Optional[torch.Generator] = None) -> Params:
    """Random init (N(0, 0.02)) with the JAX package's layout; real weights
    come from a checkpoint."""
    std = 0.02
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    def nrm(shape):
        return _normal(generator, shape, std, dtype, device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device) if cfg.attention_bias else None

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "input_norm_w": torch.ones(h, dtype=dtype, device=device),
            "q": {"w": nrm((h, nh * hd)), "b": zeros(nh * hd)},
            "k": {"w": nrm((h, nkv * hd)), "b": zeros(nkv * hd)},
            "v": {"w": nrm((h, nkv * hd)), "b": zeros(nkv * hd)},
            "o": {"w": nrm((nh * hd, h)), "b": None},
            "post_norm_w": torch.ones(h, dtype=dtype, device=device),
            "gate": nrm((h, ffn)),
            "up": nrm((h, ffn)),
            "down": nrm((ffn, h)),
        })
    return {
        "embed": nrm((cfg.vocab_size, h)),
        "layers": layers,
        "final_norm_w": torch.ones(h, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# RoPE (HF Qwen2 numerics: fp32 cos/sin, rotate-half)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> cos/sin [B, T, head_dim] (fp32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [B, T, D]."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    # KVH and D fused into one trailing dim, as in the JAX package.  With
    # k_scale/v_scale set, k/v hold int8 with per-slot symmetric scales,
    # stored broadcast over 8 rows (the JAX layout).
    k: torch.Tensor  # [L, B, S, KVH*D] (model dtype, or int8 when quantized)
    v: torch.Tensor  # [L, B, S, KVH*D]
    k_scale: Optional[torch.Tensor] = None  # [L, B, 8, S] bf16
    v_scale: Optional[torch.Tensor] = None  # [L, B, 8, S] bf16


def kv_cache_init(cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.float32,
                  quantized: bool = False, device="cpu") -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads * cfg.head_dim)
    if quantized:
        sshape = (cfg.num_hidden_layers, batch, 8, max_len)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                       v_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize_slots(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, F] -> int8 [B, T, F] + per-slot scale [B, T] bf16 (symmetric)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # the scale is rounded to bf16 first, so quantize and dequantize use the
    # identical (stored) value
    scale = (amax / 127.0).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xf / scale.clamp_min(1e-12)), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """q [B, Tq, H, D]; k/v [B, Tk, KVH, D]; additive bias [B, 1|H, Tq, Tk].

    GQA through a 5-D view (no repeated heads); softmax in fp32."""
    b, tq, nh, d = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(b, tq, nkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (d ** -0.5)
    if bias.shape[1] == nh:
        logits = logits + bias.reshape(b, nkv, g, *bias.shape[-2:])
    else:
        logits = logits + bias[:, :, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, tq, nh, d).to(q.dtype)


def _linear(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    y = x @ p["w"]
    return y if p["b"] is None else y + p["b"]


def _layer(lp: Params, cfg: Qwen2Config, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, cache_full: Optional[Tuple[KVCache, int, int, int]],
           bias: Optional[torch.Tensor],
           decode_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One decoder layer.  With `cache_full=(cache, layer, write_pos, row_off)`
    the new k/v are written in place into the stacked cache at slots
    [write_pos, write_pos+T) of rows [row_off, row_off+B), and attention reads
    this layer's cache."""
    if "qkv" in lp or "gateup" in lp:
        raise NotImplementedError(
            "fused int4 qkv/gateup weights are not ported yet (ROADMAP A7/B2)")
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    hn = rms_norm(x, lp["input_norm_w"], cfg.rms_norm_eps)
    q = apply_rope(_linear(hn, lp["q"]).reshape(b, t, nh, hd), cos, sin)
    k = apply_rope(_linear(hn, lp["k"]).reshape(b, t, nkv, hd), cos, sin)
    v = _linear(hn, lp["v"])

    if cache_full is not None:
        cache, li, pos, row_off = cache_full
        quant = cache.k_scale is not None
        k2 = k.reshape(b, t, nkv * hd)
        v2 = v
        rows = slice(row_off, row_off + b)
        slots = slice(pos, pos + t)
        if quant:
            k2, k_sc = _quantize_slots(k2)
            v2, v_sc = _quantize_slots(v2)
            cache.k_scale[li, rows, :, slots] = k_sc[:, None, :]
            cache.v_scale[li, rows, :, slots] = v_sc[:, None, :]
        # in-place slot write into the stacked cache (the JAX package's
        # aliased dynamic_update_slice)
        cache.k[li, rows, slots] = k2.to(cache.k.dtype)
        cache.v[li, rows, slots] = v2.to(cache.v.dtype)
        if decode_ctx is not None and t == 1:
            # long-cache decode: the CUDA kernel reads the layer straight out
            # of the stacked cache and stops at each row's live length
            visible, lengths = decode_ctx
            att = decode_attention(q[:, 0].contiguous(), cache.k, cache.v, li, visible,
                                   lengths, k_scale=cache.k_scale,
                                   v_scale=cache.v_scale)[:, None]
        else:
            s_max = cache.k.shape[2]
            k_att = cache.k[li, rows]
            v_att = cache.v[li, rows]
            if quant:
                k_att = k_att.to(x.dtype) * cache.k_scale[li, rows, 0].to(x.dtype)[..., None]
                v_att = v_att.to(x.dtype) * cache.v_scale[li, rows, 0].to(x.dtype)[..., None]
            att = _attend(q, k_att.reshape(b, s_max, nkv, hd),
                          v_att.reshape(b, s_max, nkv, hd), bias)
    else:
        att = _attend(q, k, v.reshape(b, t, nkv, hd), bias)
    x = x + att.reshape(b, t, nh * hd) @ lp["o"]["w"]

    hn = rms_norm(x, lp["post_norm_w"], cfg.rms_norm_eps)
    mlp = (F.silu(hn @ lp["gate"]) * (hn @ lp["up"])) @ lp["down"]
    return x + mlp


def forward(
    params: Params,
    cfg: Qwen2Config,
    inputs_embeds: torch.Tensor,          # [B, T, H]
    positions: torch.Tensor,              # [B, T] rope positions
    attn_bias: Optional[torch.Tensor],    # [B, 1, T, S] additive fp32 bias
    cache: Optional[KVCache] = None,
    write_pos: Optional[int] = None,
    decode_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    batch_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.  With `cache`, keys/values are written at slot
    `write_pos` (one host int for every row: left-padded batching) into rows
    [batch_offset, batch_offset+B), in place, and attention spans the cache;
    without, attention spans the inputs.  `attn_bias` may be None only on the
    kernel path (`decode_ctx` with T == 1).  Prefill attends densely: flash
    prefill is not ported yet (ROADMAP B5)."""
    if cache is not None and not isinstance(write_pos, int):
        raise ValueError("write_pos must be a host int: one slot shared by every row")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        cache_full = None if cache is None else (cache, li, write_pos, batch_offset)
        x = _layer(lp, cfg, x, cos, sin, cache_full, attn_bias, decode_ctx=decode_ctx)
    x = rms_norm(x, params["final_norm_w"], cfg.rms_norm_eps)
    return x, cache


def causal_bias(attention_mask: torch.Tensor, t: int) -> torch.Tensor:
    """Left-padded batch prefill bias: [B, S] pad mask -> [B, 1, T, S] additive."""
    s = attention_mask.shape[-1]
    causal = torch.tril(torch.ones((t, s), dtype=torch.bool, device=attention_mask.device),
                        diagonal=s - t)
    ok = causal[None] & attention_mask[:, None, :].bool()
    return torch.where(ok, 0.0, -1e9).float()[:, None]


def decode_bias(visible: torch.Tensor) -> torch.Tensor:
    """Decode-step bias from a [B, S] visibility mask -> [B, 1, 1, S]."""
    return torch.where(visible.bool(), 0.0, -1e9).float()[:, None, None, :]


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF convention: position_ids = cumsum(mask) - 1, clamped at 0 on pads."""
    return torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)


def embed_rows(lm_params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup from a plain [V, H] table."""
    e = lm_params["embed"]
    if isinstance(e, dict):
        raise NotImplementedError("int8 embeddings are not ported yet (ROADMAP A7)")
    return e[ids]


def logits(params: Params, cfg: Qwen2Config, hidden: torch.Tensor,
           lm_head=None) -> torch.Tensor:
    """LM head; tied to the embedding when `lm_head` is None."""
    if lm_head is None:
        return hidden @ params["embed"].T
    return hidden @ lm_head


__all__ = [
    "init",
    "forward",
    "logits",
    "embed_rows",
    "KVCache",
    "kv_cache_init",
    "rope_cos_sin",
    "apply_rope",
    "causal_bias",
    "decode_bias",
    "positions_from_mask",
]
