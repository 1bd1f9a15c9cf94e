"""VibeVoice model assembly, inference half: LM + tokenizers + connectors +
diffusion head.

Port of `vibevoice_tpu/models/vibevoice.py` (reference
`modeling_vibevoice.py:107-477`): the parameter tree, the constrained logits
head, per-frame CFG diffusion sampling, latent scaling, the speech-embedding
splice and voice-prompt encoding.  Training belongs to a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs import VibeVoiceConfig
from ..schedule import dpm_solver as ds
from ..ops import fused_head
from ..ops.int4_matmul import dequant_int4
from . import connectors, diffusion_head, qwen2, tokenizer

Params = Dict[str, Any]


def init_model(cfg: VibeVoiceConfig, dtype=torch.float32, device="cpu",
               generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters in the JAX package's tree and layouts.  The speech
    scaling factors are NaN until set (as in the reference, :131-132)."""
    h = cfg.decoder.hidden_size
    kw = dict(dtype=dtype, device=device, generator=generator)
    params = {
        "lm": qwen2.init(cfg.decoder, **kw),
        "acoustic_encoder": tokenizer.init_encoder(cfg.acoustic_tokenizer, **kw),
        "acoustic_decoder": tokenizer.init_decoder(cfg.acoustic_tokenizer, **kw),
        "semantic_encoder": tokenizer.init_encoder(cfg.semantic_tokenizer, **kw),
        "acoustic_connector": connectors.init(cfg.acoustic_vae_dim, h, **kw),
        "semantic_connector": connectors.init(cfg.semantic_vae_dim, h, **kw),
        "diffusion_head": diffusion_head.init(cfg.diffusion_head, **kw),
        "speech_scaling_factor": torch.tensor(float("nan"), device=device),
        "speech_bias_factor": torch.tensor(float("nan"), device=device),
        "lm_head": None,
    }
    if not cfg.decoder.tie_word_embeddings:
        w = torch.randn((h, cfg.decoder.vocab_size), generator=generator,
                        dtype=torch.float32, device=device)
        params["lm_head"] = (w * 0.02).to(dtype)
    return params


def lm_head_subset(params: Params, ids, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Columns of the logits head for the allowed control tokens only.

    Generation can select just 4-5 control tokens, so the per-step logits
    matmul reads [H, n] instead of the whole [H, V] head.  Each column is the
    same dot as in the full matmul, and the ids are sorted ascending, so the
    subset argmax equals the bias-masked full argmax.  Returns {"q": int8
    [H, n], "scale": [n]} for an int8 head or embedding, {"w": [H, n]}
    otherwise; an int4 head's columns are dequantized once, to `dtype`, by the
    plain `dequant_int4` (as the JAX package does)."""
    ids = sorted(set(int(i) for i in ids))
    head = params.get("lm_head")
    if head is None:
        e = params["lm"]["embed"]
        if isinstance(e, dict):  # int8 embed, per-row scales (rows = vocab)
            return {"q": e["qint8"][ids].T.contiguous(), "scale": e["scale"][ids]}
        return {"w": e[ids].T.contiguous()}
    if isinstance(head, dict):
        if "qint4" in head:
            return {"w": dequant_int4(head["qint4"][:, ids].contiguous(),
                                      head["scale4"][:, ids].contiguous(), dtype)}
        return {"q": head["qint8"][:, ids].contiguous(), "scale": head["scale"][ids]}
    return {"w": head[:, ids].contiguous()}


def lm_logits_subset(sub: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
    """Logits over the allowed-token subset (see `lm_head_subset`)."""
    if "q" in sub:
        return (hidden @ sub["q"].to(hidden.dtype)) * sub["scale"].to(hidden.dtype)
    return hidden @ sub["w"].to(hidden.dtype)


def sample_speech_latents(
    params: Params,
    cfg: VibeVoiceConfig,
    solver_cfg: ds.SolverConfig,
    sched: ds.Schedule,
    condition: torch.Tensor,      # [N, H] positive LM hidden states
    neg_condition: torch.Tensor,  # [N, H] negative (CFG) hidden states
    cfg_scale: float,
    x_init: torch.Tensor,         # [N, latent] initial noise
    step_noise: Optional[torch.Tensor] = None,  # [steps, N, latent] for SDE solvers
    sde_generator: Optional[torch.Generator] = None,  # draws SDE noise per step
    timesteps: Optional[torch.Tensor] = None,  # sched.timesteps on the device
) -> torch.Tensor:
    """DPM-Solver sampling with classifier-free guidance (ref
    `sample_speech_tokens`, modeling_vibevoice_inference.py:712-725): each
    step runs the head on the [cond; neg] doubled batch and combines
    `uncond + s * (cond - uncond)`.

    With an int4 head pack in `params["_diffusion_head_packq"]`
    (`quantize_diffusion="int4k"`) each solver step is ONE call of the fused
    head kernel (`ops.fused_head`)."""
    dh_cfg = cfg.diffusion_head
    head = params["diffusion_head"]
    cond2 = torch.cat([condition, neg_condition], dim=0)
    state = ds.init_state(solver_cfg, tuple(x_init.shape), device=x_init.device)
    if timesteps is None:
        timesteps = torch.as_tensor(sched.timesteps, device=condition.device)
    layer_mods, final_mod = diffusion_head.precompute_modulations(
        head, dh_cfg, cond2, timesteps)
    packq = params.get("_diffusion_head_packq")
    if packq is not None:
        mods_stack = torch.stack(layer_mods, dim=1)  # [S, L, N, 3H]
    x = x_init
    for i in range(sched.num_steps):
        x2 = torch.cat([x, x], dim=0)
        if packq is not None:
            eps = fused_head.fused_head_solver_step(
                packq, x2 @ head["noisy_proj"], mods_stack[i], final_mod[i],
                head["final_linear"], dh_cfg.rms_norm_eps)
        else:
            eps = diffusion_head.apply_with_modulations(
                head, dh_cfg, x2, [m[i] for m in layer_mods], final_mod[i])
        cond_eps, uncond_eps = torch.chunk(eps, 2, dim=0)
        guided = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        noise = None
        if step_noise is not None:
            noise = step_noise[i]
        elif sde_generator is not None:
            noise = torch.randn(x.shape, generator=sde_generator, dtype=torch.float32,
                                device=x.device)
        x, state = ds.step(solver_cfg, sched, i, state, guided, x, noise=noise)
    return x


def encode_voice_prompts(params: Params, cfg: VibeVoiceConfig, speech_tensors: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         sample_noise: bool = True) -> torch.Tensor:
    """audio [N, T] -> sampled acoustic latents [N, F, vae_dim] (ref
    _process_speech_inputs, modeling_vibevoice_inference.py:150-164)."""
    lat = tokenizer.encoder_apply(params["acoustic_encoder"], cfg.acoustic_tokenizer,
                                  speech_tensors[..., None])
    ac = cfg.acoustic_tokenizer
    if sample_noise and ac.std_dist_type == "gaussian":
        lat = tokenizer.vae_sample_gaussian(generator, lat, ac.fix_std)
    elif sample_noise and ac.std_dist_type == "fix":
        lat = tokenizer.vae_sample_fix(generator, lat, ac.fix_std)
    return lat


def scale_latents(params: Params, latents: torch.Tensor) -> torch.Tensor:
    """(latents + bias) * scaling (ref :159, :325)."""
    return (latents + params["speech_bias_factor"].to(latents.dtype)) * \
        params["speech_scaling_factor"].to(latents.dtype)


def unscale_latents(params: Params, latents: torch.Tensor) -> torch.Tensor:
    """latents / scaling - bias (ref :651)."""
    return latents / params["speech_scaling_factor"].to(latents.dtype) - \
        params["speech_bias_factor"].to(latents.dtype)


def splice_speech_embeds(inputs_embeds: torch.Tensor, speech_embeds: torch.Tensor,
                         speech_input_mask: torch.Tensor) -> torch.Tensor:
    """The n-th True position of the mask (row-major) takes speech_embeds[n]
    (the reference's `inputs_embeds[speech_input_mask] = speech_embeds`)."""
    b, t, h = inputs_embeds.shape
    flat_mask = speech_input_mask.reshape(-1).bool()
    idx = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    idx = idx.clamp(0, speech_embeds.shape[0] - 1)
    gathered = speech_embeds[idx].to(inputs_embeds.dtype)
    out = torch.where(flat_mask[:, None], gathered, inputs_embeds.reshape(-1, h))
    return out.reshape(b, t, h)


__all__ = [
    "init_model",
    "lm_head_subset",
    "lm_logits_subset",
    "sample_speech_latents",
    "encode_voice_prompts",
    "scale_latents",
    "unscale_latents",
    "splice_speech_embeds",
]
