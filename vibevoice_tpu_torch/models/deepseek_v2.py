"""DeepSeek-V2 causal decoder (multi-head latent attention + DeepSeekMoE) over
one latent cache.

The LM slot of a VibeVoice filled by DeepSeek-V2 (arXiv:2405.04434: §2.1 MLA,
§2.2 DeepSeekMoE; the reference code is `modeling_deepseek.py` of
huggingface.co/deepseek-ai/DeepSeek-V2-Lite).  Plain functions over a
parameter dict (linear weights [in, out]) with the same entry points as
`models/qwen2.py` (`init`, `forward`, `kv_cache_init`, `embed_rows`,
`logits`, `causal_bias`, `decode_bias`, `positions_from_mask`), so the
engine runs either decoder through one path.

A layer with input x at position p:
  h = RMSNorm(x); q = h W_q, per head q_nope [128] and q_pe [64];
  [c, k_pe] = h W_kv_a, c = RMSNorm_kv(c) [512], k_pe [64] shared by the heads;
  per head [k_nope_i, v_i] = c W_kv_b,i; q_pe and k_pe get YaRN RoPE (the
  reference's interleaved pair layout, `apply_rope`);
  score_i(s) = (q_nope_i . k_nope_i(s) + q_pe_i . k_pe(s)) * softmax_scale;
  x += concat_i(softmax(score_i) v_i) W_o; then the FFN on RMSNorm(x): a dense
  SwiGLU in the first `first_k_dense_replace` layers, else the experts:
  g = softmax_fp32(h W_router), the top-k of g (greedy, ties to the lower
  index, weights not renormalised, times `routed_scaling_factor`),
  y = sum_e g_e E_e(h) + S(h) with S the shared experts as one SwiGLU.

The cache holds one slot per token: [c, rope(k_pe)], `[L, B, S, 576]`
(`LatentCache`), written in place at `write_pos` as the Qwen2 cache is.
A prompt (T > 1 with `use_flash`) attends its own tokens in the published
form, in query blocks, per row over its real tokens (memory linear in T apart
from one block's scores).  Every other call attends the cache in the absorbed
form, which is the same sum regrouped:
  q~_i = W_kv_b^K,i q_nope_i [512];  score_i(s) = q~_i . c(s) + q_pe_i . k_pe(s);
  o~_i = sum_s p_i(s) c(s);  o_i = W_kv_b^V,i o~_i,
through the CUDA kernel `ops.mla_decode_attention` for a one-token decode
with `decode_ctx=(visible, lengths)`, or densely with an additive bias.

The experts: a call of at most `DENSE_MAX_TOKENS` tokens (every decode step)
weighs the routed experts by the dense gate matrix (zero outside the top-k)
in `_experts_dense`: on the card one launch of the CUDA kernel
`ops.moe_experts` per 16 rows, which finds on the device the experts some
row was routed to and reads only those, so nothing of the routing is read
on the host and the step can be captured (the engine counts the layers it
ran, `grouped_layers`); on the CPU all experts as batched matmuls.  A
longer call (a prompt) runs each expert on its own tokens, in chunks of
`PREFILL_CHUNK` tokens.  Every routed expert is computed exactly: no
capacity, no dropped tokens.

Not ported for this decoder (the engine raises): int8/int4 weights, an int8
cache and tensor parallelism.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config
from ..ops.mla_decode_attention import mla_decode_attention
from ..ops.moe_experts import moe_experts
from . import qwen2
from .norms import rms_norm

Params = Dict[str, Any]

# calls of at most this many tokens compute every expert (no host read)
DENSE_MAX_TOKENS = 256
# tokens routed at once in a prompt's expert layer
PREFILL_CHUNK = 32768
# queries of one block of a prompt's attention
QUERY_BLOCK = 2048

# the engine modes not ported for this decoder; `forward` tallies experts hit
UNPORTED = ("tp", "int8_kv", "quantized")
EXPERT_TALLY = True

causal_bias = qwen2.causal_bias
decode_bias = qwen2.decode_bias
positions_from_mask = qwen2.positions_from_mask
embed_rows = qwen2.embed_rows
logits = qwen2.logits  # the untied head (tied when `lm_head` is None)


def engine_routes(cfg: DeepseekV2Config, prompt_len: int, cache_len: int) -> Tuple[bool, bool]:
    """The engine's default routes, (prompt attending itself, decode kernel):
    every prompt attends itself (no [T, S] bias), and a cache of 4 096 slots
    or more decodes through the MLA kernel."""
    return True, cache_len >= 4096


def _normal(generator, shape, std, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            * std).to(dtype)


def init(cfg: DeepseekV2Config, dtype=torch.float32, *, device,
         generator: Optional[torch.Generator] = None) -> Params:
    """Random init (N(0, 0.02), norms 1); real weights come from a checkpoint."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    e, fe = cfg.n_routed_experts, cfg.moe_intermediate_size
    fs = cfg.moe_intermediate_size * cfg.n_shared_experts

    def nrm(*shape):
        return _normal(generator, shape, 0.02, dtype, device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    layers = []
    for li in range(cfg.num_hidden_layers):
        lp = {"input_norm_w": ones(h), "q": nrm(h, nh * cfg.q_head_dim),
              "kv_a": nrm(h, cfg.latent_dim), "kv_norm_w": ones(cfg.kv_lora_rank),
              "kv_b": nrm(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
              "o": nrm(nh * cfg.v_head_dim, h), "post_norm_w": ones(h)}
        if cfg.is_moe(li):
            lp.update(router=nrm(h, e), experts_gate=nrm(e, h, fe), experts_up=nrm(e, h, fe),
                      experts_down=nrm(e, fe, h), shared_gate=nrm(h, fs), shared_up=nrm(h, fs),
                      shared_down=nrm(fs, h))
        else:
            lp.update(gate=nrm(h, cfg.intermediate_size), up=nrm(h, cfg.intermediate_size),
                      down=nrm(cfg.intermediate_size, h))
        layers.append(lp)
    return {"embed": nrm(cfg.vocab_size, h), "layers": layers, "final_norm_w": ones(h)}


# ---------------------------------------------------------------------------
# YaRN RoPE (modeling_deepseek.py: DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------

def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(num_rotations: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """[rope/2] fp32 on `device`: the scaled frequencies below the band
    between beta_slow and beta_fast rotations, the original ones above it, a
    linear ramp between (made on the device: a captured step copies nothing
    from the host)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    if cfg.rope_factor <= 1:
        return extra
    inter = 1.0 / (cfg.rope_factor * base ** exps)
    orig = cfg.original_max_position_embeddings
    low = max(math.floor(_correction_dim(cfg.beta_fast, dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(cfg.beta_slow, dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_cos_sin(positions: torch.Tensor, cfg: DeepseekV2Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> cos/sin [B, T, rope] (fp32), times YaRN's
    mscale / mscale_all_dim (1 for DeepSeek-V2-Lite)."""
    inv = yarn_inv_freq(cfg, positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    m = (yarn_get_mscale(cfg.rope_factor, cfg.mscale)
         / yarn_get_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    return torch.cos(emb) * m, torch.sin(emb) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D] in the reference's interleaved pair layout, cos/sin
    [B, T, D]: the pairs are gathered into halves (x0, x2, ..., x1, x3, ...)
    and rotated as rotate-half; the result stays in the halves' layout."""
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2).transpose(3, 4).reshape(b, t, h, d)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * c + rot * s


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """q_head_dim^-0.5, times YaRN's mscale(mscale_all_dim) squared."""
    m = yarn_get_mscale(cfg.rope_factor, cfg.mscale_all_dim) if cfg.mscale_all_dim else 1.0
    return cfg.q_head_dim ** -0.5 * m * m


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

class LatentCache(NamedTuple):
    latent: torch.Tensor  # [L, B, S, kv_lora_rank + rope]: c, then rope(k_pe)


def kv_cache_init(cfg: DeepseekV2Config, batch: int, max_len: int, dtype=torch.float32,
                  quantized: bool = False, device="cpu", mesh=None) -> LatentCache:
    if quantized:
        raise ValueError("an int8 cache is not ported for the DeepSeek-V2 decoder")
    if qwen2.tp_degree(mesh) > 1:
        raise ValueError("tensor parallelism is not ported for the DeepSeek-V2 decoder")
    return LatentCache(torch.zeros((cfg.num_hidden_layers, batch, max_len, cfg.latent_dim),
                                   dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _kv_b(lp: Params, cfg: DeepseekV2Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """W_kv_b's key and value halves, [kv_lora, H, nope] and [kv_lora, H, v]."""
    w = lp["kv_b"].view(cfg.kv_lora_rank, cfg.num_attention_heads,
                        cfg.qk_nope_head_dim + cfg.v_head_dim)
    return w[..., : cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _prompt_attend(cfg: DeepseekV2Config, q: torch.Tensor, c: torch.Tensor,
                   k_pe: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The published form over one row's real tokens: q [T, H, 192], c [T,
    512], k_pe [T, 64] -> [T, H, v], causal, QUERY_BLOCK queries at a time
    (block [a, b) reads keys [0, b): one block's scores in memory)."""
    t, nh, _ = q.shape
    k_nope = torch.einsum("tc,chd->htd", c, wk)                       # [H, T, nope]
    k = torch.cat([k_nope, k_pe[None].expand(nh, t, -1)], dim=-1)       # [H, T, 192]
    v = torch.einsum("tc,chd->htd", c, wv)                            # [H, T, v]
    qh = (q.float() * scale).to(q.dtype).transpose(0, 1)                # [H, T, 192]
    out = torch.empty((nh, t, cfg.v_head_dim), dtype=q.dtype, device=q.device)
    for a in range(0, t, QUERY_BLOCK):
        b = min(t, a + QUERY_BLOCK)
        s = qh[:, a:b] @ k[:, :b].transpose(1, 2)                       # [H, b-a, b]
        diag = torch.ones((b - a, b - a), dtype=torch.bool, device=q.device).triu(1)
        s[:, :, a:b].masked_fill_(diag, float("-inf"))
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
        del s
    return out.transpose(0, 1)


def _absorbed_attend(q_lat: torch.Tensor, lat: torch.Tensor, bias: torch.Tensor,
                     kv_lora: int, scale: float) -> torch.Tensor:
    """The absorbed form over cache rows: q_lat [B, T, H, 576], lat [B, S,
    576], additive bias [B, 1, T, S] -> [B, T, H, kv_lora]; fp32 softmax."""
    s = torch.einsum("bthc,bsc->bhts", q_lat.float(), lat.float()) * scale + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bsc->bthc", p, lat[..., :kv_lora].float()).to(q_lat.dtype)


def _mla(lp: Params, cfg: DeepseekV2Config, x: torch.Tensor, cos, sin,
         cache_full, bias, decode_ctx, pad_mask, use_flash) -> torch.Tensor:
    """One layer's attention residual (x + attention(x) W_o)."""
    b, t, _ = x.shape
    nh, nope, rope = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    scale = softmax_scale(cfg)
    hn = rms_norm(x, lp["input_norm_w"], cfg.rms_norm_eps)
    q = (hn @ lp["q"]).view(b, t, nh, nope + rope)
    q_nope, q_pe = q[..., :nope], apply_rope(q[..., nope:], cos, sin)
    kv = hn @ lp["kv_a"]
    c = rms_norm(kv[..., :r], lp["kv_norm_w"], cfg.rms_norm_eps)
    k_pe = apply_rope(kv[..., r:][:, :, None, :], cos, sin)[:, :, 0]
    lat = torch.cat([c, k_pe], dim=-1)                                  # [B, T, 576]
    wk, wv = _kv_b(lp, cfg)

    if cache_full is not None:
        cache, li, pos, row_off = cache_full
        rows = slice(row_off, row_off + b)
        if isinstance(pos, int):
            idx = torch.arange(pos, pos + t, device=x.device)
        else:
            idx = pos.clamp(0, cache.latent.shape[2] - t).long() + torch.arange(t, device=x.device)
        cache.latent[li, rows].index_copy_(1, idx, lat.to(cache.latent.dtype))

    if use_flash and t > 1:
        # a prompt: its own tokens, published form, per row over its real tokens
        att = torch.zeros((b, t, nh, cfg.v_head_dim), dtype=x.dtype, device=x.device)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        for i in range(b):
            real = torch.nonzero(pad_mask[i])[:, 0] if pad_mask is not None else None
            if real is None:
                att[i] = _prompt_attend(cfg, qf[i], c[i], k_pe[i], wk, wv, scale)
            elif real.numel():
                att[i, real] = _prompt_attend(cfg, qf[i, real], c[i, real], k_pe[i, real],
                                              wk, wv, scale)
    elif cache_full is not None:
        q_lat = torch.cat([torch.einsum("bthd,chd->bthc", q_nope, wk), q_pe], dim=-1)
        if decode_ctx is not None and t == 1:
            visible, lengths = decode_ctx
            o_lat = mla_decode_attention(q_lat[:, 0].contiguous(), cache.latent, li, visible,
                                         lengths, scale, r)[:, None]
        else:
            o_lat = _absorbed_attend(q_lat, cache.latent[li, rows], bias, r, scale)
        att = torch.einsum("bthc,chd->bthd", o_lat, wv)
    else:
        # no cache: the published form over the inputs, with the bias
        k_nope = torch.einsum("btc,chd->bthd", c, wk)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, nh, rope)], dim=-1)
        v = torch.einsum("btc,chd->bthd", c, wv)
        s = torch.einsum("bqhd,bkhd->bhqk", torch.cat([q_nope, q_pe], -1).float(),
                         k.float()) * scale + bias
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float()).to(x.dtype)
    return x + att.reshape(b, t, nh * cfg.v_head_dim) @ lp["o"]


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------

def route(lp: Params, cfg: DeepseekV2Config, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, H] -> (selected [N, E] bool, gate weights [N, E] fp32, zero
    outside the selection): softmax over the router's fp32 logits, greedy
    top-k with ties to the lower expert index, not renormalised, times
    `routed_scaling_factor`."""
    scores = torch.softmax(h.float() @ lp["router"].float(), dim=-1)
    e = scores.shape[-1]
    ids = torch.arange(e, device=h.device)
    # an expert's rank: the experts scored higher, and those scored equal
    # with a lower index
    ahead = (scores[:, None, :] > scores[:, :, None]) | (
        (scores[:, None, :] == scores[:, :, None]) & (ids[None, :] < ids[:, None])[None])
    sel = ahead.sum(dim=-1) < cfg.num_experts_per_tok
    return sel, torch.where(sel, scores, 0.0) * cfg.routed_scaling_factor


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return (F.silu(x @ gate) * (x @ up)) @ down


def _experts_dense(lp: Params, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The routed experts on the tokens h [N, H], weighed by w [N, E] (fp32
    sum, [N, H]): the grouped expert kernel on the card, every expert as
    batched matmuls on the CPU (`ops.moe_experts`)."""
    return moe_experts(h, w, lp["experts_gate"], lp["experts_up"], lp["experts_down"])


def grouped_layers(cfg: DeepseekV2Config, tokens: int, device) -> int:
    """The expert layers a forward of `tokens` tokens runs on the grouped
    expert kernel: every one of a call of at most `DENSE_MAX_TOKENS` tokens
    on a CUDA device, else none."""
    if torch.device(device).type != "cuda" or tokens > DENSE_MAX_TOKENS:
        return 0
    return sum(cfg.is_moe(li) for li in range(cfg.num_hidden_layers))


def _experts_sparse(lp: Params, h: torch.Tensor, sel: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert on its own tokens of h [N, H] (one read of the counts)."""
    tok, ex = torch.nonzero(sel, as_tuple=True)
    order = torch.argsort(ex, stable=True)
    tok, ex = tok[order], ex[order]
    counts = torch.bincount(ex, minlength=sel.shape[1]).tolist()
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            ti = tok[start:start + n]
            y = _swiglu(h[ti], lp["experts_gate"][e], lp["experts_up"][e], lp["experts_down"][e])
            out.index_add_(0, ti, y.float() * w[ti, e, None])
        start += n
    return out


def moe(lp: Params, cfg: DeepseekV2Config, h: torch.Tensor, tally: Optional[torch.Tensor] = None):
    """The expert layer on h [..., H] (routed plus shared); `tally` [2]
    int64, when given, gains the distinct experts this call hit and 1."""
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    n = h2.shape[0]
    shared = _swiglu(h2, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    if n <= DENSE_MAX_TOKENS:
        sel, w = route(lp, cfg, h2)
        if tally is not None:
            tally.add_(torch.stack([sel.any(dim=0).sum(), torch.ones_like(tally[0])]))
        routed = _experts_dense(lp, h2, w)
    else:
        routed = torch.empty((n, shape[-1]), dtype=torch.float32, device=h.device)
        for a in range(0, n, PREFILL_CHUNK):
            sel, w = route(lp, cfg, h2[a:a + PREFILL_CHUNK])
            routed[a:a + PREFILL_CHUNK] = _experts_sparse(lp, h2[a:a + PREFILL_CHUNK], sel, w)
    return (routed.to(h.dtype) + shared).reshape(shape)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    cfg: DeepseekV2Config,
    inputs_embeds: torch.Tensor,          # [B, T, H]
    positions: torch.Tensor,              # [B, T] rope positions
    attn_bias: Optional[torch.Tensor],    # [B, 1, T, S] additive fp32 bias
    cache: Optional[LatentCache] = None,
    write_pos=None,                       # host int or 0-d int32 device tensor
    decode_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    batch_offset: int = 0,
    pad_mask: Optional[torch.Tensor] = None,  # [B, T] int (1 = real token)
    use_flash: bool = False,
    mesh=None,
    mark=None,
    tally: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[LatentCache]]:
    """`qwen2.forward`'s contract on the latent cache: with `cache` each
    token's latent slot is written at `write_pos` of rows [batch_offset,
    batch_offset+B), and attention spans the cache (the absorbed form); with
    `use_flash` and T > 1 a prompt attends its own tokens (the published
    form, `pad_mask` masking left pads, no bias needed).  `mark(part)`, when
    given, is called at the start of the first layer (None) and after each
    layer's attention ("lm.mla") and FFN ("lm.moe", "lm.mlp" for a dense
    one); `tally` counts the experts hit (`moe`).  A mesh with a model axis
    above 1 raises."""
    if qwen2.tp_degree(mesh) > 1:
        raise ValueError("tensor parallelism is not ported for the DeepSeek-V2 decoder")
    if cache is not None and not (isinstance(write_pos, int) or (
            torch.is_tensor(write_pos) and write_pos.dim() == 0
            and not write_pos.is_floating_point())):
        raise ValueError("write_pos must be a host int or a 0-d integer tensor: one slot "
                         "shared by every row")
    cos, sin = rope_cos_sin(positions, cfg)
    x = inputs_embeds
    if mark is not None:
        mark(None)
    for li, lp in enumerate(params["layers"]):
        cache_full = None if cache is None else (cache, li, write_pos, batch_offset)
        x = _mla(lp, cfg, x, cos, sin, cache_full, attn_bias, decode_ctx, pad_mask, use_flash)
        if mark is not None:
            mark("lm.mla")
        hn = rms_norm(x, lp["post_norm_w"], cfg.rms_norm_eps)
        if cfg.is_moe(li):
            x = x + moe(lp, cfg, hn, tally)
        else:
            x = x + _swiglu(hn, lp["gate"], lp["up"], lp["down"])
        if mark is not None:
            mark("lm.moe" if cfg.is_moe(li) else "lm.mlp")
    x = rms_norm(x, params["final_norm_w"], cfg.rms_norm_eps)
    return x, cache


__all__ = ["UNPORTED", "EXPERT_TALLY", "engine_routes", "init", "forward", "logits", "embed_rows", "LatentCache", "kv_cache_init",
           "route", "moe", "grouped_layers", "yarn_inv_freq", "yarn_get_mscale", "rope_cos_sin", "apply_rope",
           "softmax_scale", "causal_bias", "decode_bias", "positions_from_mask",
           "DENSE_MAX_TOKENS", "PREFILL_CHUNK", "QUERY_BLOCK"]
