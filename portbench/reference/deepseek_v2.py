"""The plain reference of DeepSeek-V2 as the LM of a VibeVoice: the prompt's
latent cache, and one decode step from a given state.

Plain PyTorch in float32 with TF32 off (`model.plain_precision`), written from
the published description (DeepSeek-V2, arXiv:2405.04434, §2.1-2.2) and
`modeling_deepseek.py` of huggingface.co/deepseek-ai/DeepSeek-V2-Lite, with no
kernel, no absorbed attention and no batching: multi-head latent attention
in its published form (each slot's k_nope and v decompressed from its c_kv
by W_kv_b, every head over every slot it may see, an explicit softmax), the
experts as a loop over the experts each token was routed to, and YaRN RoPE
from its formula.  Long inputs are taken in blocks: a layer's weights are
upcast from the served type one layer at a time, and a prompt's queries
`block` at a time.  It imports nothing of the program.

Departures from `modeling_deepseek.py`, none of which changes the
mathematics: a tie between router scores goes to the lower expert index (the
reference's `torch.topk` leaves ties unspecified); the expert outputs are
weighed and summed in float32 (as `moe_infer` does).

`param_spec` is the whole VibeVoice tree with this LM (the port's layout:
linear weights [in, out], the experts stacked [E, in, out]) and the
distribution of each leaf; the speech parts are `model.py`'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import model as R
from .configs import config_from_dict as vibevoice_from_dict
from .norms import rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The DeepSeek-V2 decoder's published keys (DeepSeek-V2-Lite's values
    by default; `rope_scaling` flattened)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


def decoder_from_dict(dec: dict) -> DeepseekV2Config:
    rs = dec.get("rope_scaling") or {}
    kw = {f.name: dec[f.name] for f in dataclasses.fields(DeepseekV2Config) if f.name in dec}
    names = {"factor": "rope_factor", "original_max_position_embeddings":
             "original_max_position_embeddings", "beta_fast": "beta_fast",
             "beta_slow": "beta_slow", "mscale": "mscale", "mscale_all_dim": "mscale_all_dim"}
    kw.update({names[k]: v for k, v in rs.items() if k in names})
    if not rs:
        kw["rope_factor"] = 1.0
    return DeepseekV2Config(**kw)


def config_from_dict(d: dict):
    """The reference's VibeVoice config with this decoder."""
    return dataclasses.replace(vibevoice_from_dict(d),
                               decoder=decoder_from_dict(d["decoder_config"]))


# ---------------------------------------------------------------------------
# the parameter tree and the distribution of each leaf
# ---------------------------------------------------------------------------

def _w(*shape) -> R.Leaf:
    return R.Leaf(tuple(shape), 0.0, R.W_STD)


def _lm_spec(cfg: DeepseekV2Config) -> Params:
    """Matrices N(0, 0.02) (the published init's std), norm scales
    1 + N(0, 0.05) as the Qwen2 cells' (`model.py`)."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    e, fe, fs = cfg.n_routed_experts, cfg.moe_intermediate_size, \
        cfg.moe_intermediate_size * cfg.n_shared_experts
    r = cfg.kv_lora_rank
    layers = []
    for li in range(cfg.num_hidden_layers):
        lp = {"input_norm_w": R._norm(h), "q": _w(h, nh * cfg.q_head_dim),
              "kv_a": _w(h, r + cfg.qk_rope_head_dim), "kv_norm_w": R._norm(r),
              "kv_b": _w(r, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
              "o": _w(nh * cfg.v_head_dim, h), "post_norm_w": R._norm(h)}
        if cfg.is_moe(li):
            lp.update(router=_w(h, e), experts_gate=_w(e, h, fe), experts_up=_w(e, h, fe),
                      experts_down=_w(e, fe, h), shared_gate=_w(h, fs), shared_up=_w(h, fs),
                      shared_down=_w(fs, h))
        else:
            lp.update(gate=_w(h, cfg.intermediate_size), up=_w(h, cfg.intermediate_size),
                      down=_w(cfg.intermediate_size, h))
        layers.append(lp)
    return {"embed": _w(cfg.vocab_size, h), "layers": layers, "final_norm_w": R._norm(h)}


def param_spec(cfg) -> Params:
    """The whole tree: this LM, the untied head, and `model.py`'s speech parts."""
    dec = cfg.decoder
    return {
        "lm": _lm_spec(dec),
        "acoustic_encoder": R._encoder_spec(cfg.acoustic_tokenizer),
        "acoustic_decoder": R._decoder_spec(cfg.acoustic_tokenizer),
        "semantic_encoder": R._encoder_spec(cfg.semantic_tokenizer),
        "acoustic_connector": R._connector_spec(cfg.acoustic_vae_dim, dec.hidden_size),
        "semantic_connector": R._connector_spec(cfg.semantic_vae_dim, dec.hidden_size),
        "diffusion_head": R._head_spec(cfg.diffusion_head),
        "lm_head": None if dec.tie_word_embeddings else _w(dec.hidden_size, dec.vocab_size),
    }


# ---------------------------------------------------------------------------
# YaRN RoPE, from its formula (modeling_deepseek.py: yarn_* and
# DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """[rope/2]: freq_inter where the ramp is 1, freq_extra where it is 0."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / base ** pos
    if cfg.rope_factor <= 1:
        return freq_extra
    freq_inter = 1.0 / (cfg.rope_factor * base ** pos)

    def corr_dim(rot):
        return dim * math.log(cfg.original_max_position_embeddings / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(corr_dim(cfg.beta_fast)), 0)
    high = min(math.ceil(corr_dim(cfg.beta_slow)), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return freq_inter * (1 - extra_mask) + freq_extra * extra_mask


def rope_cos_sin(positions: torch.Tensor, cfg: DeepseekV2Config):
    """positions [T] -> cos/sin [T, rope], times mscale / mscale_all_dim."""
    freqs = torch.outer(positions.float(), inv_freq(cfg).to(positions.device))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(cfg.rope_factor, cfg.mscale) / yarn_mscale(cfg.rope_factor,
                                                                cfg.mscale_all_dim)
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, heads, D] as the reference lays it out, pairs interleaved: view
    as [D/2, 2], transpose, then rotate-half; cos/sin [T, D]."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) if cfg.mscale_all_dim else 1.0
    return cfg.q_head_dim ** -0.5 * m * m


# ---------------------------------------------------------------------------
# one layer, published form
# ---------------------------------------------------------------------------

def layer_latent(lp: Params, cfg: DeepseekV2Config, x: torch.Tensor, positions: torch.Tensor):
    """x [T, H] -> q [T, heads, nope + rope] (q_pe roped) and the slot each
    token leaves in the cache, [T, kv_lora + rope]: c_kv normed, then the
    roped k_pe."""
    nh, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    hn = rms_norm(x, lp["input_norm_w"], cfg.rms_norm_eps)
    cos, sin = rope_cos_sin(positions, cfg)
    q = (hn @ lp["q"]).view(-1, nh, cfg.q_head_dim)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], dim=-1)
    kv = hn @ lp["kv_a"]
    c = rms_norm(kv[:, :r], lp["kv_norm_w"], cfg.rms_norm_eps)
    k_pe = apply_rope(kv[:, None, r:], cos, sin)[:, 0]
    return q, torch.cat([c, k_pe], dim=-1)


def attend(lp: Params, cfg: DeepseekV2Config, q: torch.Tensor, slots: torch.Tensor,
           causal: bool, block: int = 512) -> torch.Tensor:
    """q [Tq, heads, nope + rope] over the slots [Tk, kv_lora + rope]:
    k_nope_i and v_i of each slot from its c_kv, keys [k_nope_i, k_pe], an
    explicit softmax -> [Tq, heads * v].  Causal aligns the last query with
    the last slot."""
    nh, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    tq, tk = q.shape[0], slots.shape[0]
    kv = (slots[:, :r] @ lp["kv_b"]).view(tk, nh, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope], slots[:, None, r:].expand(tk, nh, cfg.qk_rope_head_dim)],
                  dim=-1).permute(1, 2, 0)                             # [heads, D, Tk]
    v = kv[..., nope:].permute(1, 0, 2)                                  # [heads, Tk, v]
    scale = softmax_scale(cfg)
    out = torch.empty((tq, nh, cfg.v_head_dim), dtype=q.dtype, device=q.device)
    for a in range(0, tq, block):
        b = min(tq, a + block)
        kb = b + tk - tq if causal else tk  # the slots this block's queries may see
        s = (q[a:b].transpose(0, 1) @ k[..., :kb]) * scale               # [heads, b-a, kb]
        if causal:
            qpos = torch.arange(a, b, device=q.device) + (tk - tq)
            ok = torch.arange(kb, device=q.device)[None, :] <= qpos[:, None]
            s = s.masked_fill(~ok[None], float("-inf"))
        out[a:b] = (torch.softmax(s, dim=-1) @ v[:, :kb]).transpose(0, 1)
        del s
    return out.reshape(tq, nh * cfg.v_head_dim)


def route(lp: Params, cfg: DeepseekV2Config, h: torch.Tensor):
    """Each token's experts and weights: softmax of the fp32 logits, the
    top-k scores (a stable sort: ties to the lower index), unnormalised,
    times routed_scaling_factor -> (ids [N, k], weights [N, k])."""
    scores = torch.softmax(h.float() @ lp["router"].float(), dim=-1)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    ids = order[:, : cfg.num_experts_per_tok]
    w = scores.gather(1, ids)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return ids, w * cfg.routed_scaling_factor


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def routed(lp: Params, cfg: DeepseekV2Config, h: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighed sum on h [N, H]: each expert on the
    tokens sent to it."""
    ids, w = route(lp, cfg, h)
    y = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        out = _swiglu(h[tok], lp["experts_gate"][e], lp["experts_up"][e], lp["experts_down"][e])
        y.index_add_(0, tok, out * w[tok, slot, None])
    return y


def moe(lp: Params, cfg: DeepseekV2Config, h: torch.Tensor) -> torch.Tensor:
    """The expert layer on h [N, H]: the routed experts plus the shared ones."""
    return routed(lp, cfg, h) + _swiglu(h, lp["shared_gate"], lp["shared_up"], lp["shared_down"])


def expert_layers(lm: Params, cfg: DeepseekV2Config, hs: Sequence[torch.Tensor],
                  wt: Optional[Callable] = None):
    """Each expert layer on its given input (hs[i] [N, H] for the i-th expert
    layer) -> the routed sums and the layers' outputs, each [N, n_moe * H]."""
    moe_layers = [lp for li, lp in enumerate(lm["layers"]) if cfg.is_moe(li)]
    ys, outs = [], []
    for lp, h in zip(moe_layers, hs):
        lp = _layer_f32(lp, wt)
        h = h.float()
        y = routed(lp, cfg, h)
        ys.append(y)
        outs.append(y + _swiglu(h, lp["shared_gate"], lp["shared_up"], lp["shared_down"]))
        del lp
    return torch.cat(ys, dim=-1), torch.cat(outs, dim=-1)


def layer_rest(lp: Params, cfg: DeepseekV2Config, li: int, x: torch.Tensor,
               att: torch.Tensor) -> torch.Tensor:
    """The o projection's residual, then the FFN's (experts or dense)."""
    x = x + att @ lp["o"]
    hn = rms_norm(x, lp["post_norm_w"], cfg.rms_norm_eps)
    if cfg.is_moe(li):
        return x + moe(lp, cfg, hn)
    return x + _swiglu(hn, lp["gate"], lp["up"], lp["down"])


def _layer_f32(lp: Params, wt: Optional[Callable]) -> Params:
    lp = R.to_f32(lp)
    return lp if wt is None else wt(lp)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def lm_prompt(lm: Params, cfg: DeepseekV2Config, rows: Sequence[torch.Tensor],
              wt: Optional[Callable] = None, block: int = 512):
    """Each row's prompt embeddings [T_r, H] (positions 0..T_r-1) through the
    decoder -> the last position's final hidden state [R, H] and each row's
    cache slots [L, T_r, kv_lora + rope].  `wt` transforms each layer's
    float32 weights (the float8 reference)."""
    xs = [r.float() for r in rows]
    lat: List[list] = [[] for _ in rows]
    for li, lp in enumerate(lm["layers"]):
        lp = _layer_f32(lp, wt)
        for i, x in enumerate(xs):
            q, slots = layer_latent(lp, cfg, x, torch.arange(x.shape[0], device=x.device))
            lat[i].append(slots)
            xs[i] = layer_rest(lp, cfg, li, x, attend(lp, cfg, q, slots, True, block))
        del lp
    final = lm["final_norm_w"].float()
    h = torch.stack([rms_norm(x[-1], final, cfg.rms_norm_eps) for x in xs])
    return h, [torch.stack(s) for s in lat]


def lm_step(lm: Params, cfg: DeepseekV2Config, x: torch.Tensor, positions: Sequence[int],
            past: Callable[[int, int], torch.Tensor], wt: Optional[Callable] = None):
    """One token per sequence: x [N, H] at `positions`, each attending the
    slots `past(layer, n)` gives ([S_n, kv_lora + rope], any float type) and
    its own -> the final hidden states [N, H] and the new slots [L, N,
    kv_lora + rope]."""
    x = x.float()
    pos = torch.as_tensor(list(positions), device=x.device)
    new = []
    for li, lp in enumerate(lm["layers"]):
        lp = _layer_f32(lp, wt)
        q, slots = layer_latent(lp, cfg, x, pos)
        att = [attend(lp, cfg, q[n:n + 1], torch.cat([past(li, n).float(), slots[n:n + 1]]),
                      False) for n in range(x.shape[0])]
        x = layer_rest(lp, cfg, li, x, torch.cat(att))
        new.append(slots)
        del lp
    h = rms_norm(x, lm["final_norm_w"].float(), cfg.rms_norm_eps)
    return h, torch.stack(new)


def lm_slot0(lm: Params, cfg: DeepseekV2Config, x: torch.Tensor, positions: Sequence[int],
             wt: Optional[Callable] = None) -> torch.Tensor:
    """The first layer's slots [N, kv_lora + rope] of inputs x [N, H] at
    `positions`: what a step writes into the cache's first layer."""
    lp = _layer_f32(lm["layers"][0], wt)
    return layer_latent(lp, cfg, x.float(), torch.as_tensor(list(positions), device=x.device))[1]


__all__ = ["DeepseekV2Config", "decoder_from_dict", "config_from_dict", "param_spec",
           "inv_freq", "rope_cos_sin", "apply_rope", "softmax_scale", "layer_latent", "attend",
           "route", "routed", "moe", "expert_layers", "layer_rest", "lm_prompt", "lm_step", "lm_slot0"]
