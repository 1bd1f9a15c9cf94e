"""Qwen2 causal decoder over one stacked KV cache.

Port of `vibevoice_tpu/models/qwen2.py`: RoPE (theta 1e6), GQA, RMSNorm,
SwiGLU MLP, biased q/k/v projections, HF Qwen2 numerics.  Plain functions over
the same parameter dict as the JAX package (linear weights [in, out]).  Every
projection goes through `utils.quantize.mm`, so a layer may hold plain, int8 or
int4 weights, including the int4 modes' fused `qkv` and `gateup` matrices.

The KV cache is one preallocated `[L, B, S, KVH*D]` pair, written in place at
one slot range per call (`write_pos`, shared by every row: a host int, or a 0-d
int32 device tensor as the decode step passes it, and `batch_offset` rows).  With `decode_ctx=(visible, lengths)` a one-token decode
reads the cache through the split-K CUDA kernel `ops.decode_attention`; with
`use_flash` a prompt (T > 1) attends its own fresh k/v through the flash
prefill kernel `ops.flash_attention` (memory linear in T, no bias); every
other call attends densely with an additive fp32 bias.

Tensor parallelism (`mesh` with a `model` axis of mp > 1, `parallel.mesh`):
the layer holds this rank's shard of the weights (q/k/v/gate/up split by
column, o/down by row), so it computes H/mp query heads and KVH/mp KV heads,
its cache holds their (KVH/mp)*D lanes, and both kernels run on those heads
alone; the o and down products are summed over the model group (they have no
bias, so nothing is added twice).  With gradients on (training) those sums and
the replicated inputs of the column-split products go through
`parallel.autograd` (`reduce_from`, `copy_to`), so the backward sums the
replicated leaves' gradients over the group too.  An int8 cache takes one amax per slot over
ALL KVH*D lanes, as the unsharded cache does: the k and v amaxes are reduced
(max) over the group in one collective before quantizing.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import Qwen2Config
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention_prefill
from ..parallel.autograd import copy_to, reduce_from
from ..utils.quantize import mm
from .norms import rms_norm

Params = Dict[str, Any]

# what the engine asks of its decoder module (`deepseek_v2` has the same): the
# engine modes not ported for it, and whether `forward` tallies experts hit
UNPORTED: Tuple[str, ...] = ()
EXPERT_TALLY = False


def engine_routes(cfg: Qwen2Config, prompt_len: int, cache_len: int) -> Tuple[bool, bool]:
    """The engine's default routes, (flash prefill, decode kernel): a prompt
    of 1 024 tokens or more takes the flash prefill kernel and a cache of
    4 096 slots or more the decode kernel, where the head width is a multiple
    of 128."""
    fits = cfg.head_dim % 128 == 0
    return prompt_len >= 1024 and fits, cache_len >= 4096 and fits


def _normal(generator, shape, std, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            * std).to(dtype)


def init(cfg: Qwen2Config, dtype=torch.float32, *, device,
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


def tp_degree(mesh) -> int:
    """The size of the mesh's `model` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape["model"]


def local_heads(cfg: Qwen2Config, mesh=None) -> Tuple[int, int]:
    """(query heads, KV heads) of this rank's shard; ValueError when the TP
    degree does not divide the KV heads (GQA groups must stay whole)."""
    mp = tp_degree(mesh)
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nkv % mp:
        raise ValueError(f"TP degree {mp} must divide num_key_value_heads {nkv}")
    return nh // mp, nkv // mp


def kv_cache_init(cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.float32,
                  quantized: bool = False, device="cpu", mesh=None) -> KVCache:
    """The zeroed cache; under TP (`mesh`) its lanes are this rank's KV heads."""
    shape = (cfg.num_hidden_layers, batch, max_len,
             local_heads(cfg, mesh)[1] * cfg.head_dim)
    if quantized:
        sshape = (cfg.num_hidden_layers, batch, 8, max_len)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                       v_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize_slots(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, F] -> int8 [B, T, F] + per-slot scale [B, T] bf16 (symmetric).
    `amax` [B, T, 1] overrides the slots' own (under TP: the whole slot's)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    # the scale is rounded to bf16 first, so quantize and dequantize use the
    # identical (stored) value
    scale = (amax / 127.0).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xf / scale.clamp_min(1e-12)), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def _quantize_kv(k: torch.Tensor, v: torch.Tensor, mesh=None):
    """Both streams' int8 slots.  Under TP each rank holds a slice of a slot's
    lanes, so the per-slot amaxes are reduced (max) over the model group, k's
    and v's in ONE collective, before quantizing: the scales, and so the
    stored values, are the unsharded cache's."""
    amax = torch.stack([k.float().abs().amax(dim=-1, keepdim=True),
                        v.float().abs().amax(dim=-1, keepdim=True)])
    if tp_degree(mesh) > 1:
        mesh.all_reduce(amax, "model", op="max")
    kq, ks = _quantize_slots(k, amax[0])
    vq, vs = _quantize_slots(v, amax[1])
    return kq, ks, vq, vs


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
    y = mm(x, p["w"])
    return y if p["b"] is None else y + p["b"]


def _layer(lp: Params, cfg: Qwen2Config, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, cache_full: Optional[Tuple[KVCache, int, int, int]],
           bias: Optional[torch.Tensor],
           decode_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           pad_mask: Optional[torch.Tensor] = None, use_flash: bool = False,
           mesh=None) -> torch.Tensor:
    """One decoder layer.  With `cache_full=(cache, layer, write_pos, row_off)`
    the new k/v are written in place into the stacked cache at slots
    [write_pos, write_pos+T) of rows [row_off, row_off+B), and attention reads
    this layer's cache, except with `use_flash` and T > 1: then it spans
    exactly the new k/v (in the model dtype, also over an int8 cache), causal,
    with `pad_mask` [B, T] masking the left pads.  Under TP (`mesh`) the
    layer computes this rank's heads and sums o and down over the group."""
    b, t, _ = x.shape
    (nh, nkv), hd = local_heads(cfg, mesh), cfg.head_dim

    hn = copy_to(rms_norm(x, lp["input_norm_w"], cfg.rms_norm_eps), mesh)
    if "qkv" in lp:  # int4 layout: q/k/v in one packed matrix, one kernel call
        qkv = _linear(hn, lp["qkv"])
        q, k, v = qkv[..., : nh * hd], qkv[..., nh * hd: (nh + nkv) * hd], \
            qkv[..., (nh + nkv) * hd:]
    else:
        q, k, v = _linear(hn, lp["q"]), _linear(hn, lp["k"]), _linear(hn, lp["v"])
    q = apply_rope(q.reshape(b, t, nh, hd), cos, sin)
    k = apply_rope(k.reshape(b, t, nkv, hd), cos, sin)

    if cache_full is not None:
        cache, li, pos, row_off = cache_full
        quant = cache.k_scale is not None
        k2 = k.reshape(b, t, nkv * hd)
        v2 = v
        rows = slice(row_off, row_off + b)
        if quant:
            k2, k_sc, v2, v_sc = _quantize_kv(k2, v2, mesh)
        # in-place slot write into the stacked cache (the JAX package's
        # aliased dynamic_update_slice); a device position's start is
        # clamped so the write fits, as dynamic_update_slice clamps a traced
        # start
        if isinstance(pos, int):
            idx = torch.arange(pos, pos + t, device=x.device)
        else:
            idx = pos.clamp(0, cache.k.shape[2] - t).long() + torch.arange(t, device=x.device)
        if quant:
            cache.k_scale[li, rows].index_copy_(2, idx, k_sc[:, None, :].expand(b, 8, t))
            cache.v_scale[li, rows].index_copy_(2, idx, v_sc[:, None, :].expand(b, 8, t))
        cache.k[li, rows].index_copy_(1, idx, k2.to(cache.k.dtype))
        cache.v[li, rows].index_copy_(1, idx, v2.to(cache.v.dtype))
    if use_flash and t > 1:
        # prefill: memory-linear attention over the fresh k/v
        vr = v.reshape(b, t, nkv, hd).contiguous()
        att = flash_attention_prefill(q, k, vr, pad_mask, causal=True)
    elif cache_full is not None:
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
    x = x + reduce_from(mm(att.reshape(b, t, nh * hd), lp["o"]["w"]), mesh)

    hn = copy_to(rms_norm(x, lp["post_norm_w"], cfg.rms_norm_eps), mesh)
    if "gateup" in lp:  # int4 layout: gate|up in one packed matrix
        gu = mm(hn, lp["gateup"])
        ffn = gu.shape[-1] // 2
        mlp = mm(F.silu(gu[..., :ffn]) * gu[..., ffn:], lp["down"])
    else:
        mlp = mm(F.silu(mm(hn, lp["gate"])) * mm(hn, lp["up"]), lp["down"])
    return x + reduce_from(mlp, mesh)


def forward(
    params: Params,
    cfg: Qwen2Config,
    inputs_embeds: torch.Tensor,          # [B, T, H]
    positions: torch.Tensor,              # [B, T] rope positions
    attn_bias: Optional[torch.Tensor],    # [B, 1, T, S] additive fp32 bias
    cache: Optional[KVCache] = None,
    write_pos=None,                       # host int or 0-d int32 device tensor
    decode_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    batch_offset: int = 0,
    pad_mask: Optional[torch.Tensor] = None,  # [B, T] int (1 = real token)
    use_flash: bool = False,
    mesh=None,                            # parallel.Mesh: TP over its `model` axis
    mark=None,
    tally=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.  With `cache`, keys/values are written at slot
    `write_pos` (one slot for every row: left-padded batching; a host int, or
    a 0-d integer tensor on the cache's device, which a captured decode step
    needs) into rows [batch_offset, batch_offset+B), in place, and attention
    spans the cache;
    without, attention spans the inputs.  With `use_flash` and T > 1,
    attention spans exactly the inputs' own k/v through the flash prefill
    kernel, masked by `pad_mask`.  `attn_bias` may be None only on the kernel
    paths (`decode_ctx` with T == 1, or `use_flash`).  With a `mesh` whose
    `model` axis is larger than 1 the params are this rank's shard and the
    cache its lanes (`kv_cache_init(..., mesh=mesh)`).  `mark` and `tally`,
    the traced engine's hooks inside the LM (`deepseek_v2.forward`), go
    unused here."""
    if cache is not None and not (isinstance(write_pos, int) or (
            torch.is_tensor(write_pos) and write_pos.dim() == 0
            and not write_pos.is_floating_point())):
        raise ValueError("write_pos must be a host int or a 0-d integer tensor: one slot "
                         "shared by every row")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        cache_full = None if cache is None else (cache, li, write_pos, batch_offset)
        x = _layer(lp, cfg, x, cos, sin, cache_full, attn_bias, decode_ctx=decode_ctx,
                   pad_mask=pad_mask, use_flash=use_flash, mesh=mesh)
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
    """Embedding lookup from a plain [V, H] table or an int8 dict with per-row
    scales (only the gathered rows are dequantized)."""
    e = lm_params["embed"]
    if isinstance(e, dict):
        return e["qint8"][ids].to(e["scale"].dtype) * e["scale"][ids][..., None]
    return e[ids]


def logits(params: Params, cfg: Qwen2Config, hidden: torch.Tensor,
           lm_head=None) -> torch.Tensor:
    """LM head; tied to the embedding when `lm_head` is None.  Takes an int8
    embedding and a quantized head."""
    if lm_head is None:
        e = params["embed"]
        if isinstance(e, dict):  # int8 embed: h @ q^T, then per-row scales
            return (hidden @ e["qint8"].to(hidden.dtype).T) * e["scale"].to(hidden.dtype)
        return hidden @ e.T
    return mm(hidden, lm_head)


__all__ = [
    "init",
    "forward",
    "logits",
    "embed_rows",
    "KVCache",
    "kv_cache_init",
    "local_heads",
    "tp_degree",
    "rope_cos_sin",
    "apply_rope",
    "causal_bias",
    "decode_bias",
    "positions_from_mask",
]
