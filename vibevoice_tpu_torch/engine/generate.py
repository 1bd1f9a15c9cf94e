"""Generation engine: prefill and the per-frame decode step.

Port of `vibevoice_tpu/engine/generate.py` (the reference's AR loop,
`modeling_vibevoice_inference.py:328-725`).  One step per 7.5 Hz frame:

  combined [2B] LM step -> constrained token select -> per-sample flag
  updates -> CFG diffusion sampling -> streaming vocoder chunk -> semantic
  re-encode -> next input embeds

The positive and CFG-negative streams run as ONE batched [2B] LM forward over
one KV cache [L, 2B, S, KVH*D]; which slots each stream attends is carried by
a visibility mask, so the speech_start reset of the negative stream and its
lazy start are mask rewrites, never cache copies.

Where it differs from the JAX engine:
  * PyTorch runs eagerly: no jit, no donation, `scan` is a Python loop, and
    `lax.cond` is a Python `if` on whether any sample diffuses this step
    (one small device-to-host read per step).
  * The KV cache, the visibility mask and the audio/emitted/token buffers are
    updated in place (the JAX engine's donated, aliased updates); a `GenState`
    handed to `step` must not be reused afterwards.
  * The slot clock `write_pos` and the step counter are host ints.
  * Random draws come from one `torch.Generator` carried in the state; they
    differ from JAX's keys, so parity tests inject `latent_noise`.

The long-cache decode attention goes through the CUDA kernel
`ops.decode_attention` (auto-on at 4096 slots or more, with the cache rounded
up to a multiple of 2048 slots, as in the JAX engine).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..configs import VibeVoiceConfig
from ..models import connectors, qwen2, tokenizer, vibevoice
from ..schedule import dpm_solver as ds
from ..weights import to_device

Params = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for and absent, rather than running
    quietly on the CPU.

    fp32 matmuls and convolutions are pinned to full fp32 (no TF32): the
    port's parity tolerances against the JAX package assume it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Generation parameters (as in the JAX engine)."""
    speech_start_id: int
    speech_end_id: int
    speech_diffusion_id: int
    eos_id: int
    bos_id: Optional[int] = None
    cfg_scale: float = 1.3
    ddpm_steps: int = 10
    max_new_tokens: int = 128
    max_length_times: float = 2.0
    do_sample: bool = False
    # 'dpmsolver++' (default) or 'sde-dpmsolver++' (the reference gradio
    # demo's production setting, gradio_demo.py:114-118)
    algorithm_type: str = "dpmsolver++"
    # reset the negative stream at every speech_start (ref 'refresh_negative');
    # False = stale mode, where the negative context grows every step
    refresh_negative: bool = True
    # bench mode: force every step down the diffusion path
    force_diffusion: bool = False


class StepOutput(NamedTuple):
    token: torch.Tensor        # [B] int32
    audio_chunk: torch.Tensor  # [B, hop] (valid where emitted)
    emitted: torch.Tensor      # [B] bool — diffusion frame emitted this step
    finished: torch.Tensor     # [B] bool


class GenState(NamedTuple):
    # unified cache: rows [:B] positive stream, rows [B:] negative stream; both
    # write at the shared slot clock `write_pos`
    cache: qwen2.KVCache        # [L, 2B, S, KVH*D]
    visible: torch.Tensor       # [2B, S] int32
    write_pos: int              # next slot (both streams)
    pos_positions: torch.Tensor  # [B] int32 next rope position (positive)
    neg_first_slot: torch.Tensor  # [B] int32 slot of the first committed negative entry
    neg_positions: torch.Tensor  # [B] int32 next rope position (negative)
    neg_started: torch.Tensor   # [B] bool — first negative entry committed
    cur_embeds: torch.Tensor    # [B, H] next LM input
    finished: torch.Tensor      # [B] bool
    reach_max: torch.Tensor     # [B] bool
    step: int                   # decode steps completed
    max_step_per_sample: torch.Tensor  # [B] int32
    acoustic_state: List[Any]
    semantic_state: List[Any]
    frames: torch.Tensor        # [B] int32 emitted frame count
    audio: torch.Tensor         # [B, max_steps, hop] fp32 ([B, 1, hop] without keep_audio)
    emitted: torch.Tensor       # [B, max_steps] bool
    tokens: torch.Tensor        # [B, max_steps] int32
    rng: torch.Generator
    latent_noise: torch.Tensor  # [F, B, latent] injected x_T per frame (parity tests)


def select_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 do_sample: bool) -> torch.Tensor:
    """Greedy (first maximum on ties, as jnp.argmax) or multinomial selection
    over the constrained logits (ref modeling_vibevoice_inference.py:502-507)."""
    if do_sample:
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _where_state(mask: torch.Tensor, new: list, old: list) -> list:
    """Per-sample merge of two streaming-state lists."""
    def sel(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
    return [type(o)(*(sel(a, b) for a, b in zip(n, o))) for n, o in zip(new, old)]


class Engine:
    """Parameters plus the prefill/step functions for one model and shape."""

    def __init__(self, params: Params, cfg: VibeVoiceConfig, gen: GenerationConfig,
                 max_steps: int, batch: int, prompt_len: int,
                 dtype=torch.float32, inject_latent_noise: bool = False,
                 use_flash_prefill: Optional[bool] = None,
                 use_flash_decode: Optional[bool] = None,
                 use_fused_vocoder: bool = False,
                 use_fused_semantic: bool = False,
                 use_fused_stages: bool = False,
                 keep_audio: bool = True,
                 kv_dtype: str = "model",
                 mesh=None,
                 device="cuda"):
        if use_fused_vocoder or use_fused_semantic or use_fused_stages:
            raise NotImplementedError(
                "the fused sigma-VAE kernels (use_fused_*) are not ported yet "
                "(ROADMAP B3/B4/B6/B7)")
        if use_flash_prefill:  # None (auto) takes the dense prefill
            raise NotImplementedError(
                "flash prefill is not ported yet (ROADMAP B5)")
        if mesh is not None:
            raise NotImplementedError(
                "tensor/data-parallel decode is not ported yet (ROADMAP A12)")
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype must be 'model' or 'int8', got {kv_dtype}")
        self.device = resolve_device(device)
        self.inject_latent_noise = inject_latent_noise
        self.kv_quant = kv_dtype == "int8"
        # keep_audio=False drops the [B, max_steps, hop] waveform buffer;
        # streaming consumers get per-step chunks from StepOutput instead
        self.keep_audio = keep_audio
        if use_flash_decode is None:
            # long caches: the decode kernel stops at each row's live length
            use_flash_decode = ((prompt_len + max_steps) >= 4096
                                and cfg.decoder.head_dim % 128 == 0)
        self.use_flash_decode = use_flash_decode
        self.cfg = cfg
        self.gen = gen
        self.hop = cfg.speech_compress_ratio
        self.max_steps = max_steps
        self.batch = batch
        self.prompt_len = prompt_len
        self.cache_len = prompt_len + max_steps
        if self.use_flash_decode:
            # the cache width is rounded up to 2048-slot multiples, as in the
            # JAX engine; the extra slots are never written or visible
            self.cache_len = -(-self.cache_len // 2048) * 2048
        self.dtype = dtype

        self.solver_cfg = ds.SolverConfig(
            num_train_timesteps=cfg.diffusion_head.ddpm_num_steps,
            beta_schedule=cfg.diffusion_head.ddpm_beta_schedule,
            prediction_type=cfg.diffusion_head.prediction_type,
            algorithm_type=gen.algorithm_type,
        )
        self.tables = ds.make_tables(self.solver_cfg)
        self.sched = ds.set_timesteps(self.solver_cfg, self.tables, gen.ddpm_steps)
        allowed = [gen.speech_start_id, gen.speech_end_id, gen.speech_diffusion_id, gen.eos_id]
        if gen.bos_id is not None:
            allowed.append(gen.bos_id)
        allowed = sorted(set(allowed))
        self.allowed_ids = torch.tensor(allowed, dtype=torch.int32, device=self.device)
        params = to_device(dict(params), self.device)
        if "_lm_head_sub" not in params:
            params["_lm_head_sub"] = vibevoice.lm_head_subset(params, allowed)
        self.params = params

    # ------------------------------------------------------------------
    def _post_lm(self, state: GenState, h_t: torch.Tensor, h_neg: torch.Tensor,
                 neg_slot: int):
        """Everything after the LM forward for one step.

        The negative stream starts lazily: its first KV entry is committed at
        a sample's FIRST diffusion step, from the current input embeds at rope
        position 0 (ref :592-604)."""
        p, cfg, gen = self.params, self.cfg, self.gen
        b = h_t.shape[0]
        dev = h_t.device
        step = state.step

        logits = vibevoice.lm_logits_subset(p["_lm_head_sub"], h_t).float()
        sel = select_token(logits, state.rng, gen.do_sample)
        next_tok = self.allowed_ids[sel.long()]
        if gen.force_diffusion:
            # force the diffusion branch, keeping the token selection live
            next_tok = torch.where(next_tok < 0, next_tok,
                                   torch.full_like(next_tok, gen.speech_diffusion_id))
        next_tok = torch.where(state.finished, torch.full_like(next_tok, gen.eos_id), next_tok)

        finished = state.finished | (next_tok == gen.eos_id)
        max_hit = (step >= state.max_step_per_sample) & ~finished
        finished = finished | max_hit
        reach_max = state.reach_max | max_hit

        is_diff = ~finished & (next_tok == gen.speech_diffusion_id)
        is_end = next_tok == gen.speech_end_id
        is_start = ~finished & (next_tok == gen.speech_start_id)

        # speech_end: zero the tokenizer streaming caches (ref :556-560)
        acoustic_state = tokenizer.state_reset_where(state.acoustic_state, is_end)
        semantic_state = tokenizer.state_reset_where(state.semantic_state, is_end)

        # speech_start: reset the negative context to its FIRST kv entry (ref
        # :563-580) — a visibility rewrite; a no-op before the negative stream
        # has started, and never in stale mode
        visible = state.visible
        if gen.refresh_negative:
            do_reset = is_start & state.neg_started
            reset_vis = torch.zeros_like(visible[b:])
            reset_vis.scatter_(1, state.neg_first_slot[:, None].long(), 1)
            visible[b:] = torch.where(do_reset[:, None], reset_vis, visible[b:])

        # ---- diffusion branch (latent -> audio -> semantic -> embeds) ----
        if bool(is_diff.any()):
            if self.inject_latent_noise:
                # frame index clamped at the last row, like JAX's gather
                f_idx = state.frames.long().clamp(max=state.latent_noise.shape[0] - 1)
                x_init = state.latent_noise[f_idx, torch.arange(b, device=dev)].to(h_t.dtype)
            else:
                x_init = torch.randn((b, cfg.acoustic_vae_dim), generator=state.rng,
                                     dtype=h_t.dtype, device=dev)
            sde_gen = state.rng if gen.algorithm_type.startswith("sde") else None
            latent = vibevoice.sample_speech_latents(
                p, cfg, self.solver_cfg, self.sched, h_t, h_neg, gen.cfg_scale, x_init,
                sde_generator=sde_gen)
            scaled = vibevoice.unscale_latents(p, latent)
            chunk, ac_new = tokenizer.decoder_apply_streaming(
                p["acoustic_decoder"], cfg.acoustic_tokenizer, scaled[:, None, :],
                acoustic_state)
            sem, sem_new = tokenizer.encoder_apply_streaming(
                p["semantic_encoder"], cfg.semantic_tokenizer, chunk, semantic_state)
            diff_embeds = (connectors.apply(p["acoustic_connector"], latent)
                           + connectors.apply(p["semantic_connector"], sem[:, 0]))
            chunk = chunk[:, :, 0]
            # diffusing samples take the new streaming states
            acoustic_state = _where_state(is_diff, ac_new, acoustic_state)
            semantic_state = _where_state(is_diff, sem_new, semantic_state)
        else:
            chunk = torch.zeros((b, self.hop), dtype=h_t.dtype, device=dev)
            diff_embeds = torch.zeros((b, cfg.decoder.hidden_size), dtype=h_t.dtype,
                                      device=dev)

        # negative bookkeeping: refresh mode commits this step's slot only on
        # diffusion steps; stale mode commits every step
        commit = is_diff if gen.refresh_negative else ~finished
        visible[b:, neg_slot] = torch.where(commit, 1, visible[b:, neg_slot])
        neg_first_slot = torch.where(commit & ~state.neg_started,
                                     torch.full_like(state.neg_first_slot, neg_slot),
                                     state.neg_first_slot)
        neg_positions = state.neg_positions + commit.to(torch.int32)
        neg_started = state.neg_started | commit

        # per-step slot writes: audio/emitted clamp at the last slot (the JAX
        # engine's dynamic_update_slice), tokens past the end are dropped (its
        # scatter)
        slot = min(step, self.max_steps - 1)
        if self.keep_audio:
            state.audio[:, slot] = torch.where(is_diff[:, None], chunk, 0.0).float()
        state.emitted[:, slot] = is_diff
        if step < self.max_steps:
            state.tokens[:, step] = next_tok
        frames = state.frames + is_diff.to(torch.int32)

        # next input embeds (ref :582-690)
        tok_embeds = qwen2.embed_rows(p["lm"], next_tok.long()).to(h_t.dtype)
        cur_embeds = torch.where(is_diff[:, None], diff_embeds, tok_embeds)

        new_state = state._replace(
            visible=visible, neg_first_slot=neg_first_slot, neg_positions=neg_positions,
            neg_started=neg_started, cur_embeds=cur_embeds, finished=finished,
            reach_max=reach_max, step=step + 1, acoustic_state=acoustic_state,
            semantic_state=semantic_state, frames=frames)
        return new_state, StepOutput(token=next_tok, audio_chunk=chunk, emitted=is_diff,
                                     finished=finished)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, input_ids, attention_mask, speech_input_mask,
                speech_tensors=None, speech_frame_masks=None,
                generator: Optional[torch.Generator] = None,
                voice_latents=None, latent_noise=None):
        """Process the prompt, build the unified cache, run step 0.

        Array arguments may be numpy or torch; `generator` defaults to a
        generator on the engine's device seeded with 0."""
        p, cfg, gen, dev = self.params, self.cfg, self.gen, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def t(x, dtype=None):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

        input_ids = t(input_ids, torch.int64)
        attention_mask = t(attention_mask, torch.int32)
        speech_input_mask = t(speech_input_mask, torch.bool)
        b, t0 = input_ids.shape
        dec = cfg.decoder
        if b != self.batch or t0 != self.prompt_len:
            raise ValueError(f"engine built for [{self.batch}, {self.prompt_len}] prompts, "
                             f"got {tuple(input_ids.shape)}")

        embeds = qwen2.embed_rows(p["lm"], input_ids).to(self.dtype)
        if speech_tensors is not None or voice_latents is not None:
            if voice_latents is None:
                latents = vibevoice.encode_voice_prompts(
                    p, cfg, t(speech_tensors).to(self.dtype), generator=generator)
            else:
                latents = t(voice_latents).to(self.dtype)  # injected (tests / precomputed)
            features = vibevoice.scale_latents(p, latents)
            flat = connectors.apply(p["acoustic_connector"], features).reshape(-1, dec.hidden_size)
            valid = t(speech_frame_masks, torch.bool).reshape(-1)
            order = torch.argsort((~valid).to(torch.int32), stable=True)
            embeds = vibevoice.splice_speech_embeds(embeds, flat[order], speech_input_mask)

        # ONE unified-cache allocation (rows [:B] positive, [B:] negative)
        cache = qwen2.kv_cache_init(dec, 2 * b, self.cache_len, self.dtype,
                                    quantized=self.kv_quant, device=dev)

        # positive prefill into rows [:B]
        bias = torch.full((b, 1, t0, self.cache_len), -1e9, dtype=torch.float32, device=dev)
        bias[:, :, :, :t0] = qwen2.causal_bias(attention_mask, t0)
        pos = qwen2.positions_from_mask(attention_mask)
        hidden, cache = qwen2.forward(p["lm"], dec, embeds, pos, bias, cache=cache,
                                      write_pos=0)
        h_last = hidden[:, -1]
        del bias

        # negative pre-seed: the speech_start kv at slot 0 of rows [B:]
        # (committed lazily at the first diffusion step)
        ss_ids = torch.full((b, 1), gen.speech_start_id, dtype=torch.int64, device=dev)
        ss_embed = qwen2.embed_rows(p["lm"], ss_ids).to(self.dtype)
        neg_bias = torch.full((b, 1, 1, self.cache_len), -1e9, dtype=torch.float32, device=dev)
        neg_bias[:, :, :, 0] = 0.0
        h_neg0, cache = qwen2.forward(p["lm"], dec, ss_embed,
                                      torch.zeros((b, 1), dtype=torch.int32, device=dev),
                                      neg_bias, cache=cache, write_pos=0, batch_offset=b)

        visible = torch.zeros((2 * b, self.cache_len), dtype=torch.int32, device=dev)
        visible[:b, :t0] = attention_mask

        init_len = attention_mask.sum(dim=-1).to(torch.int32)
        max_steps_ps = torch.minimum(
            torch.full_like(init_len, self.max_steps),
            (gen.max_length_times * init_len.float()).to(torch.int32))

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = GenState(
            cache=cache, visible=visible, write_pos=t0,
            pos_positions=init_len.clone(),
            neg_first_slot=zeros((b,), torch.int32),
            neg_positions=zeros((b,), torch.int32),
            neg_started=zeros((b,), torch.bool),
            cur_embeds=ss_embed[:, 0],
            finished=zeros((b,), torch.bool),
            reach_max=zeros((b,), torch.bool),
            step=0, max_step_per_sample=max_steps_ps,
            acoustic_state=tokenizer.decoder_state_init(cfg.acoustic_tokenizer, b, self.dtype,
                                                        device=dev),
            semantic_state=tokenizer.encoder_state_init(cfg.semantic_tokenizer, b, self.dtype,
                                                        device=dev),
            frames=zeros((b,), torch.int32),
            audio=zeros((b, self.max_steps if self.keep_audio else 1, self.hop), torch.float32),
            emitted=zeros((b, self.max_steps), torch.bool),
            tokens=zeros((b, self.max_steps), torch.int32),
            rng=generator,
            latent_noise=(t(latent_noise) if latent_noise is not None
                          else zeros((1, b, cfg.acoustic_vae_dim), self.dtype)),
        )
        # at step 0 the negative stream's "just-written" kv is the slot-0 pre-seed
        return self._post_lm(state, h_last, h_neg0[:, 0], neg_slot=0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: GenState):
        """One decode step: a combined [2B] forward over the unified cache.
        Both streams write this step's kv at slot `write_pos`; the negative
        stream's history is carried by the visibility mask."""
        p, cfg = self.params, self.cfg
        b = state.cur_embeds.shape[0]
        wp = state.write_pos
        if wp >= self.cache_len:
            raise RuntimeError(f"KV cache full ({self.cache_len} slots)")

        # each row sees its committed history plus the slot written now
        vis_step = state.visible.clone()
        vis_step[:, wp] = 1

        embeds2 = torch.cat([state.cur_embeds, state.cur_embeds], dim=0)[:, None, :]
        positions2 = torch.cat([state.pos_positions, state.neg_positions])[:, None]

        decode_ctx, bias = None, None
        if self.use_flash_decode:
            lengths = torch.full((2 * b,), wp + 1, dtype=torch.int32, device=self.device)
            decode_ctx = (vis_step, lengths)
        else:
            bias = qwen2.decode_bias(vis_step)
        hidden, _ = qwen2.forward(p["lm"], cfg.decoder, embeds2, positions2, bias,
                                  cache=state.cache, write_pos=wp, decode_ctx=decode_ctx)
        state.visible[:b, wp] = 1
        state = state._replace(write_pos=wp + 1, pos_positions=state.pos_positions + 1)
        return self._post_lm(state, hidden[:b, 0], hidden[b:, 0], neg_slot=wp)

    def decode_chunk(self, state: GenState, n: int):
        """`n` steps; the outputs are stacked on a leading [n] axis."""
        outs = []
        for _ in range(n):
            state, out = self.step(state)
            outs.append(out)
        return state, StepOutput(*(torch.stack(xs) for xs in zip(*outs)))


class GenerationResult(NamedTuple):
    tokens: np.ndarray          # [B, steps] generated control tokens
    audio: list                 # list of [T_b] float32 waveforms (or None)
    reach_max: np.ndarray       # [B] bool
    steps: int


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:  # numpy has no bf16: bf16 audio chunks come out fp32
        x = x.float()
    return x.detach().cpu().numpy()


def generate(
    engine: Engine,
    input_ids,
    attention_mask,
    speech_input_mask,
    speech_tensors=None,
    speech_frame_masks=None,
    generator: Optional[torch.Generator] = None,
    voice_latents=None,
    latent_noise=None,
    audio_streamer=None,
    stop_check_fn=None,
    check_every: int = 8,
    stream_chunk: int = 4,
    on_step=None,
) -> GenerationResult:
    """Host-side loop (ref generate :328-710).  With a streamer, a
    `stop_check_fn` or `on_step` attached it advances `stream_chunk` steps per
    chunk and hands each step's output to them; otherwise it advances in
    `check_every`-step chunks and only reads the finished flags between them.

    `on_step(out: StepOutput)` gets numpy views once per decode step — the
    engine's emitted-frame clock."""
    state, out = engine.prefill(input_ids, attention_mask, speech_input_mask,
                                speech_tensors, speech_frame_masks, generator,
                                voice_latents, latent_noise)
    b = engine.batch
    steps_done = 1

    def _feed(o: StepOutput):
        if on_step is not None:
            on_step(o)
        if audio_streamer is None:
            return
        if o.emitted.any():
            idx = np.nonzero(o.emitted)[0]
            audio_streamer.put(o.audio_chunk[idx], idx)
        if o.finished.any():
            audio_streamer.end(np.nonzero(o.finished)[0])

    _feed(StepOutput(*(_np(x) for x in out)))
    per_step = audio_streamer is not None or stop_check_fn is not None or on_step is not None
    while steps_done < engine.max_steps:
        if per_step and stop_check_fn is not None and stop_check_fn():
            break
        if bool(state.finished.all()):
            break
        n = min(max(1, stream_chunk) if per_step else check_every,
                engine.max_steps - steps_done)
        state, outs = engine.decode_chunk(state, n)
        steps_done += n
        if per_step:
            outs_np = StepOutput(*(_np(x) for x in outs))  # one read for the chunk
            for i in range(n):
                _feed(StepOutput(*(x[i] for x in outs_np)))

    if audio_streamer is not None:
        audio_streamer.end()

    frames = _np(state.frames)
    if engine.keep_audio:
        audio_buf, emitted_map = _np(state.audio), _np(state.emitted)
        audio = [audio_buf[i][emitted_map[i]].reshape(-1) if frames[i] > 0 else None
                 for i in range(b)]
    else:
        audio = [None] * b  # streaming consumers got the chunks already
    tokens = _np(state.tokens)[:, : min(state.step, engine.max_steps)]
    return GenerationResult(tokens=tokens, audio=audio, reach_max=_np(state.reach_max),
                            steps=steps_done)


__all__ = ["Engine", "GenerationConfig", "GenState", "StepOutput",
           "GenerationResult", "generate", "select_token", "resolve_device"]
