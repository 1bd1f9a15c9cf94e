"""The plain reference of one VibeVoice generation: prompt, first frames, and
one decode step from a given state.

Plain PyTorch in float32 with TF32 off (`plain_precision`), written from the
port's model code as it stands (frozen copies beside this file) without its
kernels, cache layout tricks or batching: the Qwen2 decoder attends with an
explicit softmax over the slots a row may see; the prompt is run row by row
with its left pads dropped.  It imports nothing of the program.

`param_spec` is the parameter tree (the port's layout: linear weights
[in, out], conv [K, Cin/groups, Cout], transposed conv [Cin, K, Cout]) with
the distribution each leaf is drawn from; the benchmark makes the weights
from it (`portbench/weights.py`) and hands the same tensors to the program
and to this reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import connectors, diffusion_head, tokenizer
from . import dpm_solver as ds
from .configs import VibeVoiceConfig
from .norms import rms_norm

Params = Dict[str, Any]


def plain_precision():
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the parameter tree and the distribution of each leaf
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """A weight drawn as mean + std * N(0, 1)."""
    shape: Tuple[int, ...]
    mean: float
    std: float


# Random weights whose audio depends on the LM: the LM's, the head's and the
# connectors' matrices N(0, 0.02) as the reference initialises the LM; the
# sigma-VAE's convs and FFNs N(0, 1/fan_in) (its published init, N(0, 0.01)
# with 1e-6 layer scales, gives audio that its biases carry and its latents
# barely move), its layer scales 0.5 + N(0, 0.05); the head's adaLN and final
# layers N(0, 0.05), not zero; every bias N(0, 0.02) and every norm scale
# 1 + N(0, 0.05), so that neither can be dropped unseen.
W_STD, BIAS_STD, NORM, GAMMA, ADA_STD = 0.02, 0.02, (1.0, 0.05), (0.5, 0.05), 0.05
SPEECH_SCALING, SPEECH_BIAS = 0.8, 0.1


def _w(*shape, std=W_STD) -> Leaf:
    return Leaf(tuple(shape), 0.0, std)


def _norm(n) -> Leaf:
    return Leaf((n,), *NORM)


def _lm_spec(cfg) -> Params:
    h, f = cfg.hidden_size, cfg.intermediate_size
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    def b(n):
        return _bias(n, cfg.attention_bias)
    layers = [{
        "input_norm_w": _norm(h),
        "q": {"w": _w(h, nh * hd), "b": b(nh * hd)},
        "k": {"w": _w(h, nkv * hd), "b": b(nkv * hd)},
        "v": {"w": _w(h, nkv * hd), "b": b(nkv * hd)},
        "o": {"w": _w(nh * hd, h), "b": None},
        "post_norm_w": _norm(h),
        "gate": _w(h, f), "up": _w(h, f), "down": _w(f, h),
    } for _ in range(cfg.num_hidden_layers)]
    return {"embed": _w(cfg.vocab_size, h), "layers": layers, "final_norm_w": _norm(h)}


def _fan_in(*shape, fan_in) -> Leaf:
    return _w(*shape, std=fan_in ** -0.5)


def _bias(n, on=True) -> Optional[Leaf]:
    return _w(n, std=BIAS_STD) if on else None


def _conv(k, cin, cout, bias) -> Params:
    return {"w": _fan_in(k, cin, cout, fan_in=k * cin), "b": _bias(cout, bias)}


def _block(dim, cfg) -> Params:
    groups = dim if cfg.mixer_layer == "depthwise_conv" else 1
    ffn, bias = cfg.ffn_expansion * dim, cfg.conv_bias
    return {
        "norm_w": _norm(dim),
        "mixer": _conv(7, dim // groups, dim, bias),
        "gamma": Leaf((dim,), *GAMMA),
        "ffn_norm_w": _norm(dim),
        "ffn1": {"w": _fan_in(dim, ffn, fan_in=dim), "b": _bias(ffn, bias)},
        "ffn2": {"w": _fan_in(ffn, dim, fan_in=ffn), "b": _bias(dim, bias)},
        "ffn_gamma": Leaf((dim,), *GAMMA),
    }


def _encoder_spec(cfg) -> Params:
    depths = cfg.encoder_depths
    n = len(depths)
    dims = tokenizer.encoder_dims(cfg.encoder_n_filters, n)
    strides = list(reversed(cfg.encoder_ratios))
    down = [_conv(cfg.kernel_size, cfg.channels, dims[0], cfg.conv_bias)]
    down += [_conv(2 * strides[i], dims[i], dims[i + 1], cfg.conv_bias) for i in range(n - 1)]
    return {"down": down,
            "stages": [[_block(dims[i], cfg) for _ in range(depths[i])] for i in range(n)],
            "final_norm_w": None if cfg.disable_last_norm else _norm(dims[-1]),
            "head": _conv(cfg.last_kernel_size, dims[-1], cfg.vae_dim, cfg.conv_bias)}


def _decoder_spec(cfg) -> Params:
    depths = cfg.decoder_depths_resolved()
    n = len(depths)
    dims = tokenizer.decoder_dims(cfg.decoder_n_filters, n)
    strides = list(cfg.decoder_ratios)
    up = [_conv(cfg.kernel_size, cfg.vae_dim, dims[0], cfg.conv_bias)]
    for i in range(n - 1):  # transposed conv [Cin, K, Cout]: 2 taps reach each sample
        up.append({"w": _fan_in(dims[i], 2 * strides[i], dims[i + 1], fan_in=2 * dims[i]),
                   "b": _bias(dims[i + 1], cfg.conv_bias)})
    return {"up": up,
            "stages": [[_block(dims[i], cfg) for _ in range(depths[i])] for i in range(n)],
            "final_norm_w": None if cfg.disable_last_norm else _norm(dims[-1]),
            "head": _conv(cfg.last_kernel_size, dims[-1], cfg.channels, cfg.conv_bias)}


def _head_spec(cfg) -> Params:
    h, lat, f = cfg.hidden_size, cfg.latent_size, int(cfg.hidden_size * cfg.head_ffn_ratio)
    return {
        "noisy_proj": _w(lat, h), "cond_proj": _w(h, h),
        "t_mlp1": _w(cfg.freq_embed_size, h), "t_mlp2": _w(h, h),
        "layers": [{"ada_w": _w(h, 3 * h, std=ADA_STD), "norm_w": _norm(h),
                    "gate": _w(h, f), "up": _w(h, f), "down": _w(f, h)}
                   for _ in range(cfg.head_layers)],
        "final_ada_w": _w(h, 2 * h, std=ADA_STD),
        "final_linear": _w(h, lat, std=ADA_STD),
    }


def _connector_spec(din, h) -> Params:
    return {"fc1": {"w": _w(din, h), "b": _bias(h)}, "norm_w": _norm(h),
            "fc2": {"w": _w(h, h), "b": _bias(h)}}


def param_spec(cfg: VibeVoiceConfig) -> Params:
    """The whole tree in the port's layout; `speech_scaling_factor` and
    `speech_bias_factor` are fixed float32 scalars (`SPEECH_SCALING`,
    `SPEECH_BIAS`), made apart."""
    dec = cfg.decoder
    return {
        "lm": _lm_spec(dec),
        "acoustic_encoder": _encoder_spec(cfg.acoustic_tokenizer),
        "acoustic_decoder": _decoder_spec(cfg.acoustic_tokenizer),
        "semantic_encoder": _encoder_spec(cfg.semantic_tokenizer),
        "acoustic_connector": _connector_spec(cfg.acoustic_vae_dim, dec.hidden_size),
        "semantic_connector": _connector_spec(cfg.semantic_vae_dim, dec.hidden_size),
        "diffusion_head": _head_spec(cfg.diffusion_head),
        "lm_head": None if dec.tie_word_embeddings else _w(dec.hidden_size, dec.vocab_size),
    }


def to_f32(tree):
    """The same tree with every tensor in float32 (a copy of each)."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_f32(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) else tree


# ---------------------------------------------------------------------------
# the Qwen2 decoder, one layer at a time over lists of sequences
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [T] -> cos/sin [T, head_dim] (HF Qwen2: rotate-half)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[:, None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, heads, D]; cos/sin [T, D]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _linear(x, p):
    y = x @ p["w"]
    return y if p["b"] is None else y + p["b"]


def layer_kv(lp: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x [T, H] -> q [T, nh, hd] and k, v [T, nkv*hd] (k roped), fp32."""
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    hn = rms_norm(x, lp["input_norm_w"], cfg.rms_norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(_linear(hn, lp["q"]).reshape(-1, nh, hd), cos, sin)
    k = apply_rope(_linear(hn, lp["k"]).reshape(-1, nkv, hd), cos, sin)
    return q, k.reshape(-1, nkv * hd), _linear(hn, lp["v"])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           block: int = 1024) -> torch.Tensor:
    """q [Tq, nh, hd] over k, v [Tk, nkv*hd] (GQA: each KV head serves its
    group of query heads), an explicit softmax in fp32, `block` queries at a
    time -> [Tq, nh*hd].  Causal aligns the last query with the last key."""
    tq, nh, hd = q.shape
    tk = k.shape[0]
    nkv = k.shape[1] // hd
    g = nh // nkv
    kh = k.reshape(tk, nkv, hd).permute(1, 0, 2)        # [nkv, Tk, hd]
    vh = v.reshape(tk, nkv, hd).permute(1, 0, 2)
    out = torch.empty((tq, nh, hd), dtype=q.dtype, device=q.device)
    for a in range(0, tq, block):
        b = min(tq, a + block)
        qb = q[a:b].reshape(b - a, nkv, g, hd).permute(1, 2, 0, 3).reshape(nkv, g * (b - a), hd)
        s = (qb @ kh.transpose(1, 2)) * hd ** -0.5      # [nkv, g*(b-a), Tk]
        if causal:
            qpos = torch.arange(a, b, device=q.device) + (tk - tq)
            ok = torch.arange(tk, device=q.device)[None, :] <= qpos[:, None]
            s = s.masked_fill(~ok.repeat(g, 1)[None], float("-inf"))
        o = torch.softmax(s, dim=-1) @ vh               # [nkv, g*(b-a), hd]
        out[a:b] = o.reshape(nkv, g, b - a, hd).permute(2, 0, 1, 3).reshape(b - a, nh, hd)
    return out.reshape(tq, nh * hd)


def layer_rest(lp: Params, cfg, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """The o projection's residual, then the SwiGLU MLP's."""
    x = x + att @ lp["o"]["w"]
    hn = rms_norm(x, lp["post_norm_w"], cfg.rms_norm_eps)
    return x + (F.silu(hn @ lp["gate"]) * (hn @ lp["up"])) @ lp["down"]


def lm_prompt(lm: Params, cfg, rows: Sequence[torch.Tensor]):
    """Each row's prompt embeddings [T_r, H] (pads dropped, positions
    0..T_r-1) through the decoder -> the last position's final hidden state
    [R, H] and each row's (k, v) per layer, [L, T_r, nkv*hd] each."""
    xs = [r.float() for r in rows]
    ks = [[] for _ in rows]
    vs = [[] for _ in rows]
    for lp in lm["layers"]:
        lp = to_f32(lp)
        for i, x in enumerate(xs):
            q, k, v = layer_kv(lp, cfg, x, torch.arange(x.shape[0], device=x.device))
            ks[i].append(k)
            vs[i].append(v)
            xs[i] = layer_rest(lp, cfg, x, attend(q, k, v, causal=True))
        del lp
    final = lm["final_norm_w"].float()
    h = torch.stack([rms_norm(x[-1], final, cfg.rms_norm_eps) for x in xs])
    return h, [torch.stack(k) for k in ks], [torch.stack(v) for v in vs]


def lm_step(lm: Params, cfg, x: torch.Tensor, positions: Sequence[int],
            past: Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]):
    """One token per sequence: x [N, H] at `positions`, each attending the
    keys `past(layer, n)` gives ([S_n, nkv*hd] k and v, any float type) and
    its own -> the final hidden states [N, H] and the new k, v [L, N, nkv*hd]."""
    x = x.float()
    pos = torch.as_tensor(list(positions), device=x.device)
    new_k, new_v = [], []
    for li, lp in enumerate(lm["layers"]):
        lp = to_f32(lp)
        q, k, v = layer_kv(lp, cfg, x, pos)
        att = []
        for n in range(x.shape[0]):
            pk, pv = past(li, n)
            att.append(attend(q[n:n + 1], torch.cat([pk.float(), k[n:n + 1]]),
                              torch.cat([pv.float(), v[n:n + 1]]), causal=False))
        x = layer_rest(lp, cfg, x, torch.cat(att))
        new_k.append(k)
        new_v.append(v)
        del lp
    h = rms_norm(x, lm["final_norm_w"].float(), cfg.rms_norm_eps)
    return h, torch.stack(new_k), torch.stack(new_v)


def lm_kv0(lm: Params, cfg, x: torch.Tensor, positions: Sequence[int]):
    """The first layer's k, v [N, nkv*hd] of inputs x [N, H] at `positions`:
    what a step writes into the cache's first layer for its input."""
    lp = to_f32(lm["layers"][0])
    _, k, v = layer_kv(lp, cfg, x.float(), torch.as_tensor(list(positions), device=x.device))
    return k, v


# ---------------------------------------------------------------------------
# speech: voice prompts, the diffusion head, the sigma-VAE and the connectors
# ---------------------------------------------------------------------------

def voice_latents(p: Params, cfg: VibeVoiceConfig, audio: torch.Tensor,
                  generator: torch.Generator, draw_dtype) -> torch.Tensor:
    """Voice prompts [N, T] -> sampled acoustic latents [N, F, vae] (ref
    _process_speech_inputs :150-164, 'gaussian' sampling).  The sampling
    noise is drawn as the program draws it, from a generator seeded alike on
    the same kind of device, in `draw_dtype`, batch std first."""
    enc = to_f32(p["acoustic_encoder"])
    ac = cfg.acoustic_tokenizer
    mean = torch.cat([tokenizer.encoder_apply(enc, ac, a[None, :, None].float())
                      for a in audio])
    n = mean.shape[0]
    std = torch.randn(n, generator=generator, dtype=draw_dtype, device=mean.device).float()
    eps = torch.randn(mean.shape, generator=generator, dtype=draw_dtype,
                      device=mean.device).float()
    return mean + (std * (ac.fix_std / 0.8)).reshape(n, 1, 1) * eps


def scale_latents(latents: torch.Tensor) -> torch.Tensor:
    return (latents + SPEECH_BIAS) * SPEECH_SCALING


def unscale_latents(latents: torch.Tensor) -> torch.Tensor:
    return latents / SPEECH_SCALING - SPEECH_BIAS


class Solver(NamedTuple):
    cfg: ds.SolverConfig
    sched: ds.Schedule


def solver(cfg: VibeVoiceConfig, algorithm_type: str, steps: int) -> Solver:
    dh = cfg.diffusion_head
    scfg = ds.SolverConfig(num_train_timesteps=dh.ddpm_num_steps,
                           beta_schedule=dh.ddpm_beta_schedule,
                           prediction_type=dh.prediction_type, algorithm_type=algorithm_type)
    return Solver(scfg, ds.set_timesteps(scfg, ds.make_tables(scfg), steps))


def sample_latents(head: Params, cfg: VibeVoiceConfig, sv: Solver, cond: torch.Tensor,
                   neg: torch.Tensor, cfg_scale: float, x_init: torch.Tensor) -> torch.Tensor:
    """Classifier-free guided DPM-Solver sampling (ref sample_speech_tokens,
    modeling_vibevoice_inference.py:712-725) from x_T = `x_init` [N, latent];
    `head` in float32."""
    dh = cfg.diffusion_head
    cond2 = torch.cat([cond, neg]).float()
    x = x_init.float()
    state = ds.init_state(sv.cfg, tuple(x.shape), device=x.device)
    timesteps = torch.as_tensor(sv.sched.timesteps, device=x.device)
    layer_mods, final_mod = diffusion_head.precompute_modulations(head, dh, cond2, timesteps)
    for i in range(sv.sched.num_steps):
        eps = diffusion_head.apply_with_modulations(head, dh, torch.cat([x, x]),
                                                    [m[i] for m in layer_mods], final_mod[i])
        c, u = torch.chunk(eps, 2)
        x, state = ds.step(sv.cfg, sv.sched, i, state, u + cfg_scale * (c - u), x)
    return x


def modulations(head: Params, cfg: VibeVoiceConfig, sv: Solver,
                cond2: torch.Tensor) -> List[torch.Tensor]:
    """The head's per-step adaLN matrices for the two streams' hidden states
    `cond2` [2N, H] at the solver's timesteps: each layer's [S, 2N, 3H], then
    the final [S, 2N, 2H]; `head` in float32."""
    timesteps = torch.as_tensor(sv.sched.timesteps, device=cond2.device)
    layer_mods, final_mod = diffusion_head.precompute_modulations(
        head, cfg.diffusion_head, cond2.float(), timesteps)
    return list(layer_mods) + [final_mod]


def solver_steps(head: Params, cfg: VibeVoiceConfig, sv: Solver, cfg_scale: float,
                 xs: Sequence[torch.Tensor], layer_mods: Sequence[torch.Tensor],
                 final_mod: torch.Tensor) -> List[torch.Tensor]:
    """Each step of one CFG sampling, teacher-forced: step i's next sample
    from the given sample `xs[i]` [N, latent] and modulations (`layer_mods`
    [S, 2N, 3H] each, `final_mod` [S, 2N, 2H]), the solver's history from the
    earlier steps' own predictions; `head` in float32."""
    dh = cfg.diffusion_head
    state = ds.init_state(sv.cfg, tuple(xs[0].shape), device=xs[0].device)
    out = []
    for i, x in enumerate(xs):
        x = x.float()
        eps = diffusion_head.apply_with_modulations(head, dh, torch.cat([x, x]),
                                                    [m[i].float() for m in layer_mods],
                                                    final_mod[i].float())
        c, u = torch.chunk(eps, 2)
        nxt, state = ds.step(sv.cfg, sv.sched, i, state, u + cfg_scale * (c - u), x)
        out.append(nxt)
    return out


class Frame(NamedTuple):
    latent: torch.Tensor     # [N, latent]
    audio: torch.Tensor      # [N, hop]
    embeds: torch.Tensor     # [N, H]: the next step's input
    acoustic_state: list
    semantic_state: list


def speech_frame(p32: Params, cfg: VibeVoiceConfig, sv: Solver, cfg_scale: float,
                 h_pos: torch.Tensor, h_neg: torch.Tensor, x_init: torch.Tensor,
                 acoustic_state: list, semantic_state: list) -> Frame:
    """One diffusion frame from the two streams' hidden states: the latent,
    its audio chunk through the streaming decoder, the semantic re-encode of
    that chunk and the next input embedding (ref :582-690).  `p32` holds the
    head, decoder, semantic encoder and connectors in float32."""
    latent = sample_latents(p32["diffusion_head"], cfg, sv, h_pos, h_neg, cfg_scale, x_init)
    chunk, ac = tokenizer.decoder_apply_streaming(
        p32["acoustic_decoder"], cfg.acoustic_tokenizer, unscale_latents(latent)[:, None],
        acoustic_state)
    sem, se = tokenizer.encoder_apply_streaming(p32["semantic_encoder"], cfg.semantic_tokenizer,
                                                chunk, semantic_state)
    embeds = (connectors.apply(p32["acoustic_connector"], latent)
              + connectors.apply(p32["semantic_connector"], sem[:, 0]))
    return Frame(latent, chunk[:, :, 0], embeds, ac, se)


def speech_params_f32(p: Params) -> Params:
    return {k: to_f32(p[k]) for k in ("diffusion_head", "acoustic_decoder", "semantic_encoder",
                                      "acoustic_connector", "semantic_connector")}


def states_rows(states: list, rows: Sequence[int]) -> list:
    """The given rows of a streaming-state list, in float32."""
    idx = torch.as_tensor(list(rows))
    return [type(st)(*(x[idx.to(x.device)].float() for x in st)) for st in states]


def zero_states(cfg: VibeVoiceConfig, n: int, device) -> Tuple[list, list]:
    return (tokenizer.decoder_state_init(cfg.acoustic_tokenizer, n, device=device),
            tokenizer.encoder_state_init(cfg.semantic_tokenizer, n, device=device))


# ---------------------------------------------------------------------------
# the prompt and the first frames, from the inputs alone
# ---------------------------------------------------------------------------

class Prompt(NamedTuple):
    """One row's prompt as the reference takes it: the real tokens only."""
    ids: torch.Tensor             # [T] token ids
    speech_mask: torch.Tensor     # [T] bool: positions that take voice frames
    voice_frames: torch.Tensor    # [n_frames, vae]: scaled latents in order


def prompt_embeds(p: Params, pr: Prompt) -> torch.Tensor:
    e = p["lm"]["embed"][pr.ids].float()
    if pr.voice_frames.shape[0]:
        feats = connectors.apply(to_f32(p["acoustic_connector"]), pr.voice_frames.float())
        e[pr.speech_mask] = feats
    return e


def first_frames(p: Params, cfg: VibeVoiceConfig, sv: Solver, cfg_scale: float,
                 prompts: List[Prompt], speech_start_id: int, x_init: torch.Tensor,
                 n_frames: int):
    """The audio of the first `n_frames` frames [N, hop] of each prompt's
    generation when every step diffuses (the prefill's frame, then decode
    steps), and each prompt's k and v [L, T_r, nkv*hd] as the prefill leaves
    them in the cache.  The positive stream attends its prompt and its frames; the
    CFG-negative stream starts from the speech_start embedding at position 0
    and attends only its own entries (the reference's refresh_negative).
    `x_init` [n_frames, N, latent] is each frame's x_T."""
    dec = cfg.decoder
    dev = x_init.device
    n = len(prompts)
    h_pos, kp, vp = lm_prompt(p["lm"], dec, [prompt_embeds(p, pr) for pr in prompts])
    prompt_kv = (kp, vp)
    ss = p["lm"]["embed"][torch.full((1,), speech_start_id, device=dev)].float()
    h_neg, kn, vn = lm_prompt(p["lm"], dec, [ss[0:1]])
    kn, vn = [kn[0]] * n, [vn[0]] * n
    h_neg = h_neg.expand(n, -1)
    p32 = speech_params_f32(p)
    ac, se = zero_states(cfg, n, dev)
    pos = [pr.ids.shape[0] for pr in prompts]
    neg_pos = [1] * n
    out = []
    for f in range(n_frames):
        fr = speech_frame(p32, cfg, sv, cfg_scale, h_pos, h_neg, x_init[f], ac, se)
        out.append(fr.audio)
        ac, se = fr.acoustic_state, fr.semantic_state
        if f + 1 == n_frames:
            break
        x2 = torch.cat([fr.embeds, fr.embeds])
        keys = kp + kn
        vals = vp + vn

        def past(li, j, keys=keys, vals=vals):
            return keys[j][li], vals[j][li]
        h, nk, nv = lm_step(p["lm"], dec, x2, pos + neg_pos, past)
        h_pos, h_neg = h[:n], h[n:]
        kp = [torch.cat([kp[j], nk[:, j:j + 1]], dim=1) for j in range(n)]
        vp = [torch.cat([vp[j], nv[:, j:j + 1]], dim=1) for j in range(n)]
        kn = [torch.cat([kn[j], nk[:, n + j:n + j + 1]], dim=1) for j in range(n)]
        vn = [torch.cat([vn[j], nv[:, n + j:n + j + 1]], dim=1) for j in range(n)]
        pos = [q + 1 for q in pos]
        neg_pos = [q + 1 for q in neg_pos]
    return out, prompt_kv


__all__ = ["plain_precision", "Leaf", "param_spec", "SPEECH_SCALING", "SPEECH_BIAS", "to_f32",
           "lm_prompt", "lm_step", "lm_kv0", "voice_latents", "scale_latents",
           "unscale_latents", "Solver", "solver", "sample_latents", "modulations",
           "solver_steps", "Frame", "speech_frame",
           "speech_params_f32", "states_rows", "zero_states", "Prompt", "prompt_embeds",
           "first_frames"]
