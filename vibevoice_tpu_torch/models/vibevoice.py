"""VibeVoice model assembly: LM + tokenizers + connectors + diffusion head.

Port of `vibevoice_tpu/models/vibevoice.py` (reference
`modeling_vibevoice.py:107-477`): the parameter tree, the logits head and its
constrained subset, per-frame CFG diffusion sampling, latent scaling, the
speech-embedding splice, voice-prompt encoding, and the training forward
(`training_forward`: LM cross-entropy + diffusion loss) with the speech
scaling statistics it needs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config, VibeVoiceConfig
from ..device import resolve_device
from ..schedule import dpm_solver as ds
from ..schedule import timestep_sampler
from ..ops import fused_head, fused_head_bf16
from ..ops.int4_matmul import dequant_int4
from ..parallel.autograd import copy_to, gather_last
from . import connectors, deepseek_v2, diffusion_head, qwen2, tokenizer

Params = Dict[str, Any]


def decoder_module(dec):
    """The module of the LM a decoder config names: `deepseek_v2` for a
    `DeepseekV2Config`, else `qwen2`.  Both have `init`, `forward`,
    `kv_cache_init`, `embed_rows`, `logits` and the bias helpers."""
    return deepseek_v2 if isinstance(dec, DeepseekV2Config) else qwen2


def init_model(cfg: VibeVoiceConfig, dtype=torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None) -> Params:
    """Random parameters in the JAX package's tree and layouts, on `device`
    (CUDA unless the caller asks for the CPU; `generator` lives there).  The
    speech scaling factors are NaN until set (as in the reference,
    :131-132)."""
    device = resolve_device(device)
    h = cfg.decoder.hidden_size
    kw = dict(dtype=dtype, device=device, generator=generator)
    params = {
        "lm": decoder_module(cfg.decoder).init(cfg.decoder, **kw),
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


def lm_logits(params: Params, cfg: VibeVoiceConfig, hidden: torch.Tensor) -> torch.Tensor:
    return decoder_module(cfg.decoder).logits(params["lm"], cfg.decoder, hidden,
                                              params["lm_head"])


def _whole_columns(x: torch.Tensor, ids, mesh) -> torch.Tensor:
    """Columns `ids` of a matrix (or vector) split by column over the mesh's
    model axis, whole on every rank: each rank places the columns that it
    holds into zeros, and the group sums them (exact: one value and zeros)."""
    width = x.shape[-1]
    lo = mesh.axis_index("model") * width
    out = torch.zeros(*x.shape[:-1], len(ids), dtype=x.dtype, device=x.device)
    for j, i in enumerate(ids):
        if lo <= i < lo + width:
            out[..., j] = x[..., i - lo]
    return mesh.all_reduce(out, "model")


def lm_head_subset(params: Params, ids, dtype=torch.bfloat16, mesh=None) -> Dict[str, Any]:
    """Columns of the logits head for the allowed control tokens only.

    Generation can select just 4-5 control tokens, so the per-step logits
    matmul reads [H, n] instead of the whole [H, V] head.  Each column is the
    same dot as in the full matmul, and the ids are sorted ascending, so the
    subset argmax equals the bias-masked full argmax.  Returns {"q": int8
    [H, n], "scale": [n]} for an int8 head or embedding, {"w": [H, n]}
    otherwise; an int4 head's columns are dequantized once, to `dtype`, by the
    plain `dequant_int4` (as the JAX package does).

    Under TP (`mesh` with a `model` axis larger than 1) an untied head is this
    rank's column shard [H, V/mp]; the subset is assembled whole on every rank
    (one sum over the model group per leaf, once per engine).  The embedding
    is replicated."""
    ids = sorted(set(int(i) for i in ids))
    head = params.get("lm_head")
    if head is None:
        e = params["lm"]["embed"]
        if isinstance(e, dict):  # int8 embed, per-row scales (rows = vocab)
            return {"q": e["qint8"][ids].T.contiguous(), "scale": e["scale"][ids]}
        return {"w": e[ids].T.contiguous()}
    if mesh is not None and mesh.shape["model"] > 1:
        if isinstance(head, dict) and "qint4" in head:
            raise ValueError("an int4 head is not TP-adaptable; quantize with mode='int8'")
        if isinstance(head, dict):
            return {"q": _whole_columns(head["qint8"], ids, mesh),
                    "scale": _whole_columns(head["scale"], ids, mesh)}
        return {"w": _whole_columns(head, ids, mesh)}
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
    mesh=None,                    # parallel.Mesh: the head's FFN split over `model`
) -> torch.Tensor:
    """DPM-Solver sampling with classifier-free guidance (ref
    `sample_speech_tokens`, modeling_vibevoice_inference.py:712-725): each
    step runs the head on the [cond; neg] doubled batch and combines
    `uncond + s * (cond - uncond)`.

    With an int4 head pack in `params["_diffusion_head_packq"]`
    (`quantize_diffusion="int4k"`) each solver step is ONE call of the fused
    head kernel (`ops.fused_head`); with the bf16 route in
    `params["_diffusion_head_bf16"]` (`Engine` sets it, `fused_head_bf16.takes`)
    one call of the bf16 head kernel (`ops.fused_head_bf16`); otherwise the
    plain `apply_with_modulations`."""
    dh_cfg = cfg.diffusion_head
    head = params["diffusion_head"]
    cond2 = torch.cat([condition, neg_condition], dim=0)
    state = ds.init_state(solver_cfg, tuple(x_init.shape), device=x_init.device)
    if timesteps is None:
        timesteps = torch.as_tensor(sched.timesteps, device=condition.device)
    layer_mods, final_mod = diffusion_head.precompute_modulations(
        head, dh_cfg, cond2, timesteps)
    packq = params.get("_diffusion_head_packq")
    route = params.get("_diffusion_head_bf16")
    if packq is not None or route is not None:
        mods_stack = torch.stack(layer_mods, dim=1)  # [S, L, N, 3H]
    x = x_init
    for i in range(sched.num_steps):
        x2 = torch.cat([x, x], dim=0)
        if packq is not None:
            eps = fused_head.fused_head_solver_step(
                packq, x2 @ head["noisy_proj"], mods_stack[i], final_mod[i],
                head["final_linear"], dh_cfg.rms_norm_eps)
        elif route is not None:
            eps = fused_head_bf16.fused_head_bf16_step(
                route, x2 @ head["noisy_proj"], mods_stack[i], final_mod[i],
                head["final_linear"], dh_cfg.rms_norm_eps)
        else:
            eps = diffusion_head.apply_with_modulations(
                head, dh_cfg, x2, [m[i] for m in layer_mods], final_mod[i], mesh=mesh)
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


def compute_scaling_stats(latents: torch.Tensor, mask: torch.Tensor,
                          mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """scaling = 1/std(masked latents), bias = -mean (ref :307-317), as 0-d
    tensors.  With a `mesh` whose `data` axis is larger than 1, each rank's
    statistics are averaged over its data group (the JAX package's
    `lax.pmean` over `axis_name`, the reference's all_reduce): the mean of
    the ranks' statistics, not the statistics of their pooled frames."""
    m = mask[..., None].to(latents.dtype)
    n = torch.clamp(m.sum() * latents.shape[-1], min=1.0)
    mean = (latents * m).sum() / n
    var = (((latents - mean) * m) ** 2).sum() / torch.clamp(n - 1.0, min=1.0)
    stats = torch.stack([1.0 / torch.sqrt(var), -mean])
    if mesh is not None and mesh.group("data") is not None:
        stats = mesh.all_reduce(stats, "data") / mesh.shape["data"]
    return stats[0], stats[1]


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


# ---------------------------------------------------------------------------
# training forward (ref VibeVoiceForConditionalGeneration.forward :332-477)
# ---------------------------------------------------------------------------

class TrainingOutput(NamedTuple):
    logits: torch.Tensor
    diffusion_loss: torch.Tensor
    ce_loss: torch.Tensor


def _packed_order(mask: torch.Tensor) -> torch.Tensor:
    """Indices that put the True entries of a flat mask first, each group in
    its original order (`jnp.argsort(~mask, stable=True)`)."""
    return torch.argsort((~mask.bool()).to(torch.int32), stable=True)


def training_forward(
    params: Params,
    cfg: VibeVoiceConfig,
    solver_tables: ds.SolverTables,
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,            # [B, T]
    attention_mask: torch.Tensor,       # [B, T]
    speech_tensors: torch.Tensor,       # [N, Ta] target audio
    speech_masks: torch.Tensor,         # [N, F] valid-frame mask
    speech_semantic_tensors: torch.Tensor,  # [N, F, sem_dim]
    acoustic_input_mask: torch.Tensor,  # [B, T] bool: speech positions in sequence
    acoustic_loss_mask: torch.Tensor,   # [B, T] bool: positions w/ diffusion loss
    labels: Optional[torch.Tensor] = None,  # [B, T] (-100 = ignore)
    ddpm_batch_mul: int = 1,
    speeches_loss_input: Optional[torch.Tensor] = None,  # [N, F]: frames w/ diffusion loss
    injected_noise: Optional[torch.Tensor] = None,       # [N*mul, latent] parity tests
    injected_timesteps: Optional[torch.Tensor] = None,   # [N*mul]
    mesh=None,                          # parallel.Mesh: the (data, model) split
) -> TrainingOutput:
    """Training-shaped forward.  The scaling factors must already be set
    (`compute_scaling_stats` on the first batch, `train.init_scaling_stats`).
    `generator` (on the inputs' device) draws the VAE sample, the noise and
    the timesteps.  The LM attends densely with the causal bias: the port's
    kernels have no backward, and none of them runs here.

    With a `mesh`, the params are this rank's `parallel.shard_params` shard
    and the inputs its data rank's share of a global batch
    (`train.shard_batch`).  The LM and the head's FFNs run split over
    `model`; an untied `lm_head` (split by column) gives whole logits through
    a gather.  Over `data` the losses are this rank's share of the global
    batch's: `ce_loss` its CE sum over the global count of valid labels,
    `diffusion_loss` its sum, so that their sums over the data group are the
    unsharded losses."""
    dec = cfg.decoder
    if isinstance(dec, DeepseekV2Config):
        raise NotImplementedError("training is not ported for the DeepSeek-V2 decoder")
    speech_masks = speech_masks.bool()

    # embed text then splice speech features (ref :358-383).  With
    # `speeches_loss_input` the splice adds semantic features (ref :371);
    # the default path splices acoustic-connector features only (ref :383).
    embeds = params["lm"]["embed"][input_ids]
    sem_connect = connectors.apply(params["semantic_connector"], speech_semantic_tensors)
    with torch.no_grad():  # the tokenizer is frozen (ref no_grad :287)
        latents = encode_voice_prompts(params, cfg, speech_tensors, generator)
    audio_features = scale_latents(params, latents)           # [N, F, vae]
    ac_connect = connectors.apply(params["acoustic_connector"], audio_features)
    if speeches_loss_input is not None:
        combined = (ac_connect + sem_connect).reshape(-1, dec.hidden_size)
    else:
        combined = ac_connect.reshape(-1, dec.hidden_size)
    flat_valid = speech_masks.reshape(-1)
    # keep only valid frames, packed to the front (the reference's [speech_masks])
    order = _packed_order(flat_valid)
    embeds = splice_speech_embeds(embeds, combined[order], acoustic_input_mask)

    pos = qwen2.positions_from_mask(attention_mask)
    bias = qwen2.causal_bias(attention_mask, input_ids.shape[1])
    hidden, _ = qwen2.forward(params["lm"], dec, embeds, pos, bias, mesh=mesh)
    if params["lm_head"] is not None and qwen2.tp_degree(mesh) > 1:
        logits = gather_last(copy_to(hidden, mesh) @ params["lm_head"], mesh)
    else:
        logits = lm_logits(params, cfg, hidden)

    # CE loss (left to the outer script in the reference :404-406).  A gather
    # of the label's log-probability: the JAX package's one-hot sum without
    # its [B, T, V] one-hot
    if labels is not None:
        valid = labels != -100
        logp = F.log_softmax(logits.float(), dim=-1)
        target = torch.where(valid, labels, 0).long()
        ce = -logp.gather(-1, target[..., None])[..., 0]
        count = valid.sum()
        if mesh is not None and mesh.group("data") is not None:
            count = mesh.all_reduce(count.clone(), "data")  # an integer: no gradient
        ce_loss = (ce * valid).sum() / torch.clamp(count, min=1)
    else:
        ce_loss = torch.zeros((), dtype=torch.float32, device=logits.device)

    # diffusion loss (ref :411-455); with speeches_loss_input only the
    # flagged frames contribute (ref :374-375)
    if speeches_loss_input is not None:
        flat_valid = (speech_masks & speeches_loss_input.bool()).reshape(-1)
        order = _packed_order(flat_valid)
    flat_latents = audio_features.reshape(-1, cfg.acoustic_vae_dim)[order]
    cond = hidden.reshape(-1, dec.hidden_size)
    cond_packed = cond[_packed_order(acoustic_loss_mask.reshape(-1))]

    # the first N loss positions condition the N frames, invalid ones
    # included (frame_valid masks those below), as in the JAX package
    speech_rep = torch.repeat_interleave(flat_latents, ddpm_batch_mul, dim=0)
    cond_rep = torch.repeat_interleave(cond_packed[: flat_latents.shape[0]], ddpm_batch_mul,
                                       dim=0)
    n_rep = speech_rep.shape[0]
    if injected_noise is not None:
        noise = injected_noise.to(speech_rep.dtype)
        timesteps = injected_timesteps
    else:
        noise = torch.randn(speech_rep.shape, generator=generator, dtype=speech_rep.dtype,
                            device=speech_rep.device)
        timesteps = timestep_sampler.uniform_sample(generator, n_rep,
                                                    cfg.diffusion_head.ddpm_num_steps)

    noisy = ds.add_noise(solver_tables, speech_rep, noise, timesteps)
    pred = diffusion_head.apply(params["diffusion_head"], cfg.diffusion_head,
                                noisy, timesteps.to(speech_rep.dtype), cond_rep, mesh=mesh)
    if cfg.diffusion_head.prediction_type == "epsilon":
        target = noise
    else:
        target = ds.get_velocity(solver_tables, speech_rep, noise, timesteps)

    frame_valid = torch.repeat_interleave(flat_valid[order], ddpm_batch_mul, dim=0)
    se = ((pred.float() - target.float()) ** 2).sum(-1)
    diffusion_loss = (se * frame_valid).sum() / cfg.acoustic_vae_dim / ddpm_batch_mul
    return TrainingOutput(logits=logits, diffusion_loss=diffusion_loss, ce_loss=ce_loss)


__all__ = [
    "init_model",
    "lm_logits",
    "lm_head_subset",
    "lm_logits_subset",
    "sample_speech_latents",
    "encode_voice_prompts",
    "scale_latents",
    "unscale_latents",
    "splice_speech_embeds",
    "compute_scaling_stats",
    "TrainingOutput",
    "training_forward",
]
