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

The compiled step (the JAX engine's `jax.jit` of `_step_impl` / `_chunk_impl`):
on a CUDA device the first `decode_chunk` after a prefill runs one step on a
side stream (the warm-up, which also makes the kernels' per-stream workspaces)
and captures the next in a `torch.cuda.CUDAGraph` over the engine's static
state buffers; every later step of every request of the engine is a replay of
that one graph.  The step reads nothing back from the device: `write_pos` and
`step` are 0-d int32 device tensors (the KV, audio, emitted and token writes
are index copies at them), and the diffusion branch runs on every step, its
outputs merged per row by `is_diff` (the captured form of `lax.cond`).  The
host keeps its own mirror of the step count (`GenState.host_step`) for the
cache-full check and `generate`.  `Engine(eager=True)` runs the same step
eagerly on the card (the counterpart of `jax.disable_jit`, for comparisons);
on the CPU `decode_chunk` always runs it eagerly.

Where it differs from the JAX engine:
  * No donation: the KV cache, the visibility mask and the audio/emitted/token
    buffers are updated in place (the JAX engine's donated, aliased updates); a
    `GenState` handed to `step` must not be reused afterwards.  On the card the
    graph's static buffers hold the state, so an engine serves one request at
    a time: a new `prefill` takes them over.
  * Random draws come from one `torch.Generator` carried in the state; they
    differ from JAX's keys, so parity tests inject `latent_noise`.  Since the
    diffusion branch runs on every step, the generator advances on steps
    where no row diffuses too.

The long-cache decode attention goes through the CUDA kernel
`ops.decode_attention` (auto-on at 4096 slots or more, with the cache rounded
up to a multiple of 2048 slots, as in the JAX engine), and the prefill of a
prompt of 1024 tokens or more through the flash prefill kernel
`ops.flash_attention` (the JAX engine's auto rule; no [T, S] bias is built
then).  Quantized params (`utils.quantize.quantize_model`) run as they are:
int4 projections of at most 128 rows take the `ops.int4_matmul` kernel, an
int4 head pack in `params["_diffusion_head_packq"]` the fused head kernel.
With `use_fused_vocoder` / `use_fused_semantic` the small-T sigma-VAE stages
run on the chain kernel (`params["_vocoder_packs"]` / `["_semantic_packs"]`:
int4 packs where the caller injects them, as the pipeline's
`quantize_tokenizer="int4k"` does, else plain packs built here).
`use_fused_stages` puts the large-T stages of both sigma-VAE stacks on the
fused stage kernels (`ops.fused_stage`, packs in
`params["_vocoder_packs_large"]` / `["_semantic_packs_large"]`), with the JAX
engine's batch policies for the folds and the row-lane layout.

`Engine(mesh=...)` (a `parallel.Mesh`, one process a rank; the JAX engine
finds its mesh in the params' shardings, which torch tensors do not carry):
  * tensor parallel (model > 1, data = 1): the params are this rank's shard
    (`parallel.shard_params`), the cache holds its KV heads' lanes, and both
    attention kernels run on its own heads; a step sums the o, down and
    diffusion-head FFN products over the model group (and reduces the int8
    cache's slot amaxes), and gathers nothing.  Its graph is captured only
    over NCCL: gloo collectives cannot be captured, so over gloo the engine
    must be built `eager=True` (it raises otherwise);
  * data parallel (data > 1, model = 1): the params are whole, the engine
    takes the GLOBAL batch, as the JAX DP engine does, and serves this rank's
    B/dp rows (`latent_noise` split on its batch axis; the generator derived
    from the caller's and the rank, the counterpart of `fold_in(key,
    axis_index)`); a step makes no collective, so each rank captures its own
    graph.  `gather` returns the tokens, audio and flags in global row order;
    the batch policies of the fused stages read the global batch, as the JAX
    engine's do, and each rank runs those packs on its own rows.
As in the JAX engine, a data x model mesh raises NotImplementedError, and a
batch that does not split over `data` or KV heads that do not split over
`model` raise ValueError.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..configs import VibeVoiceConfig
from ..device import resolve_device
from ..parallel.mesh import check_shard_shapes
from ..models import connectors, qwen2, tokenizer, vibevoice
from ..schedule import dpm_solver as ds
from ..utils.profiling import Tracer
from ..weights import to_device

Params = Dict[str, Any]


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
    write_pos: torch.Tensor     # 0-d int32 next slot (both streams)
    pos_positions: torch.Tensor  # [B] int32 next rope position (positive)
    neg_first_slot: torch.Tensor  # [B] int32 slot of the first committed negative entry
    neg_positions: torch.Tensor  # [B] int32 next rope position (negative)
    neg_started: torch.Tensor   # [B] bool — first negative entry committed
    cur_embeds: torch.Tensor    # [B, H] next LM input
    finished: torch.Tensor      # [B] bool
    reach_max: torch.Tensor     # [B] bool
    step: torch.Tensor          # 0-d int32 decode steps completed
    max_step_per_sample: torch.Tensor  # [B] int32
    acoustic_state: List[Any]
    semantic_state: List[Any]
    frames: torch.Tensor        # [B] int32 emitted frame count
    audio: torch.Tensor         # [B, max_steps, hop] fp32 ([B, 1, hop] without keep_audio)
    emitted: torch.Tensor       # [B, max_steps] bool
    tokens: torch.Tensor        # [B, max_steps] int32
    rng: torch.Generator
    latent_noise: torch.Tensor  # [F, B, latent] injected x_T per frame (parity tests)
    host_step: int              # the host's mirror of `step`, never read from the device


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


def _leaves(state: GenState) -> List[torch.Tensor]:
    """The tensors of a state, in field order (the generator and the host
    mirror left out)."""
    out: List[torch.Tensor] = []

    def walk(x):
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    for name in GenState._fields:
        if name not in ("rng", "host_step"):
            walk(getattr(state, name))
    return out


class Gathered(NamedTuple):
    """A data-parallel engine's per-row results in global row order."""
    tokens: torch.Tensor     # [B, max_steps] int32
    audio: torch.Tensor      # [B, max_steps | 1, hop] fp32
    emitted: torch.Tensor    # [B, max_steps] bool
    frames: torch.Tensor     # [B] int32
    finished: torch.Tensor   # [B] bool
    reach_max: torch.Tensor  # [B] bool


def _copy_into(dst: GenState, src: GenState):
    """Copy every tensor of `src` into the same tensor of `dst` (skipping the
    ones that are already the same tensor)."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        if s is not d:
            if s.shape != d.shape:
                raise ValueError(f"state tensor of shape {tuple(s.shape)} does not fit the "
                                 f"engine's buffer of shape {tuple(d.shape)}")
            d.copy_(s)


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
                 fused_stage_t_min: int = 128,
                 fused_stage_tile: Optional[int] = None,
                 fused_stage_tile_semantic: Optional[int] = None,
                 fused_stage_fold_conv: Optional[bool] = None,
                 fused_stage_fold_head: Optional[bool] = None,
                 fused_stage_rowlane: Optional[bool] = None,
                 keep_audio: bool = True,
                 kv_dtype: str = "model",
                 mesh=None,
                 device="cuda",
                 eager: bool = False,
                 tracer: Optional[Tracer] = None):
        """`eager=True` runs `decode_chunk` step by step on the card rather
        than replaying the captured step (the counterpart of
        `jax.disable_jit`); on the CPU it always runs so.  `mesh`: see the
        module docstring (`batch` is the global batch under data
        parallelism).  `tracer`: see `set_tracer`; given here, it also gets
        the packs' host span "engine.pack"."""
        self.mesh = mesh
        self.dp = 1 if mesh is None else mesh.shape["data"]
        self.mp = 1 if mesh is None else mesh.shape["model"]
        if self.dp > 1 and self.mp > 1:
            raise NotImplementedError(
                "combined data x model decode sharding is not supported; use a pure-TP "
                "mesh for sharded models or a pure-DP mesh for batch serving")
        if batch % self.dp:
            raise ValueError(f"batch {batch} must divide over data axis {self.dp}")
        if cfg.decoder.num_key_value_heads % self.mp:
            raise ValueError(f"TP degree {self.mp} must divide num_key_value_heads "
                             f"{cfg.decoder.num_key_value_heads}; use a smaller model axis")
        if mesh is not None and mesh.coords is None:
            raise ValueError(f"this process (rank {mesh.rank}) is not in {mesh!r}")
        if self.mp > 1 and not eager and mesh.backend("model") != "nccl":
            raise ValueError(
                f"a tensor-parallel step over {mesh.backend('model')} cannot be captured in a "
                "CUDA graph (only NCCL collectives can): build the engine with eager=True, "
                "or use an NCCL process group")
        # the mesh the LM and the diffusion head sum their split products over
        self.tp_mesh = mesh if self.mp > 1 else None
        self.dp_index = mesh.axis_index("data") if self.dp > 1 else 0
        self.global_batch = batch
        batch //= self.dp  # the rows this rank serves
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype must be 'model' or 'int8', got {kv_dtype}")
        self.device = resolve_device(device)
        self.inject_latent_noise = inject_latent_noise
        self.use_fused_vocoder = use_fused_vocoder
        self.use_fused_semantic = use_fused_semantic
        self.use_fused_stages = use_fused_stages
        self.kv_quant = kv_dtype == "int8"
        # keep_audio=False drops the [B, max_steps, hop] waveform buffer;
        # streaming consumers get per-step chunks from StepOutput instead
        self.keep_audio = keep_audio
        if use_flash_prefill is None:
            # long prompts take the memory-linear flash prefill kernel
            use_flash_prefill = prompt_len >= 1024 and cfg.decoder.head_dim % 128 == 0
        self.use_flash_prefill = use_flash_prefill
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
        # on the device once: a host-to-device copy cannot be captured
        self.timesteps = torch.as_tensor(self.sched.timesteps, device=self.device)
        # the compiled step (CUDA only): the graph, the captures and the last
        # one's seconds, the replays so far, its static state and outputs, and
        # the generator it draws from
        self.use_graph = self.device.type == "cuda" and not eager
        self.graph = None
        self.captures = 0
        self.capture_s = None
        self.replays = 0
        self._static: Optional[GenState] = None
        self._graph_out: Optional[StepOutput] = None
        self._rng: Optional[torch.Generator] = None
        # tracing (`set_tracer`): the tracer; the part boundaries of the step
        # being run and their stamp; the captured step's own boundary events;
        # the chunk whose last replay's parts are still unread; the device
        # span (chunk or prefill) the steps run under
        self.tracer: Optional[Tracer] = None
        self._marks: Optional[list] = None
        self._stamp = None
        self._graph_marks: Optional[list] = None
        self._unread: Optional[int] = None
        self._span: Optional[int] = None
        allowed = [gen.speech_start_id, gen.speech_end_id, gen.speech_diffusion_id, gen.eos_id]
        if gen.bos_id is not None:
            allowed.append(gen.bos_id)
        allowed = sorted(set(allowed))
        self.allowed_ids = torch.tensor(allowed, dtype=torch.int32, device=self.device)
        params = to_device(dict(params), self.device)
        if mesh is not None:
            check_shard_shapes(params, cfg, self.mp)
        t_pack = time.perf_counter_ns()
        # chain packs already in the tree (the pipeline's int4 packs, or a JAX
        # engine's through `weights.from_jax`) are kept; else plain packs of
        # the weights as they are
        if use_fused_vocoder and "_vocoder_packs" not in params:
            params["_vocoder_packs"] = tokenizer.pack_decoder_stages(
                params["acoustic_decoder"], cfg.acoustic_tokenizer)
        if use_fused_semantic and "_semantic_packs" not in params:
            params["_semantic_packs"] = tokenizer.pack_encoder_stages(
                params["semantic_encoder"], cfg.semantic_tokenizer,
                chunk_t=cfg.speech_compress_ratio)
        if use_fused_stages:
            # the JAX engine's batch policies: the transition convs fold at
            # B == 1 only, the tail never unless asked, and the row-lane packs
            # at 2 <= B <= 4 and B >= 32.  On the H100 a row-lane call is the
            # stage kernel reading each row's diagonal blocks: bit-equal to
            # the plain stage kernel on the same rows and as fast within a
            # few percent at B = 2, 4 and 32 (`chip_smoke.py` phase 2,
            # PERF.md), so the JAX rule costs nothing here.
            # Packs already in the tree (e.g. a JAX engine's, through
            # `weights.from_jax`) are kept; any pack is right at any batch (a
            # row-lane pack whose row group does not divide the batch runs the
            # plain stage kernel).
            # `fused_stage_tile` / `fused_stage_tile_semantic` are the JAX
            # kernel's T-tile targets: accepted and ignored, since the stage
            # kernel does not tile T by them (as `tile_want`)
            # Under data parallelism the rules read the global batch, as the
            # JAX DP engine's do, and each rank runs those packs on its B/dp
            # rows
            gb = self.global_batch
            if fused_stage_fold_conv is None:
                fused_stage_fold_conv = gb == 1
            if fused_stage_fold_head is None:
                fused_stage_fold_head = False
            if fused_stage_rowlane is None:
                fused_stage_rowlane = 2 <= gb <= 4 or gb >= 32
            rl_batch = gb if (fused_stage_rowlane and gb > 1) else 0
            if "_vocoder_packs_large" not in params:
                params["_vocoder_packs_large"] = tokenizer.pack_decoder_stages_large(
                    params["acoustic_decoder"], cfg.acoustic_tokenizer,
                    t_min=fused_stage_t_min, fold_conv=fused_stage_fold_conv,
                    fold_head=fused_stage_fold_head, rowlane_batch=rl_batch)
            if "_semantic_packs_large" not in params:
                params["_semantic_packs_large"] = tokenizer.pack_encoder_stages_large(
                    params["semantic_encoder"], cfg.semantic_tokenizer,
                    chunk_t=cfg.speech_compress_ratio, t_min=fused_stage_t_min,
                    fold_conv=fused_stage_fold_conv, rowlane_batch=rl_batch)
        if "_lm_head_sub" not in params:
            params["_lm_head_sub"] = vibevoice.lm_head_subset(params, allowed, dtype,
                                                              mesh=self.tp_mesh)
        self.params = params
        t_end = time.perf_counter_ns()
        # the packs' seconds (always kept, as `capture_s`)
        self.pack_s = (t_end - t_pack) / 1e9
        if tracer is not None:
            tracer.add("engine.pack", t_pack, t_end)
            self.set_tracer(tracer)

    # ------------------------------------------------------------------
    def set_tracer(self, tracer: Optional[Tracer]):
        """Trace this engine into `tracer` (None: stop): each prefill and
        chunk as a device span ("engine.prefill", "engine.chunk") and the
        prefill's host span, the capture's host span, and each step's parts
        (`utils.profiling.PARTS`) under an "engine.step" span.  Eager steps
        record their parts with the tracer's stamps.  The captured step
        records its own: with a tracer set at capture time, timing events at
        the parts' boundaries are nodes of the graph (seven, the same events
        at every replay), and each chunk first reads the previous chunk's
        last replay from them if it is done, or counts it skipped (it waits
        for nothing).  Setting the tracer drops the captured graph, so the
        next `decode_chunk` captures the step again, with those events or
        without; the last chunk's replay is read first, waiting for it.
        On a CUDA device the tracer is anchored to the device's clock."""
        if self.tracer is not None:
            self._read_replay(self.tracer, wait=True)
        self.tracer, self._unread = tracer, None
        if tracer is not None and self.device.type == "cuda":
            tracer.anchor(self.device)
        self.graph, self._graph_out, self._graph_marks = None, None, None

    def _mark(self, part: str):
        """The end of `part` of the step being run (nothing untraced)."""
        if self._marks is not None:
            self._marks.append((part, self._stamp()))

    @contextlib.contextmanager
    def _marking(self, stamp):
        """Record the parts' boundaries of the step run in the block with
        `stamp`; the list it yields holds them afterwards, [(part, stamp)]
        from the step's start (part None) to the end of its last "rest"."""
        marks = [(None, stamp())]
        self._marks, self._stamp = marks, stamp
        try:
            yield marks
        finally:
            self._marks = self._stamp = None
        marks.append(("rest", stamp()))

    def _eager_marked(self, fn, *args):
        """`fn(*args)`, one step or its part after the LM, with its parts'
        spans under the current chunk or prefill when traced."""
        tr = self.tracer
        if tr is None:
            return fn(*args)
        with self._marking(tr.stamp) as marks:
            out = fn(*args)
        tr.step_spans(marks, parent=self._span)
        return out

    def _read_replay(self, tr: Tracer, wait: bool = False):
        """The parts of the last replay of the chunk left unread, from the
        graph's boundary events, if they are done (with `wait`, waiting for
        them); else a skipped sample."""
        chunk, self._unread = self._unread, None
        if chunk is None:
            return
        marks = self._graph_marks
        if wait:
            marks[-1][1].synchronize()
        elif not marks[-1][1].query():
            tr.count("part_samples_skipped")
            return
        tr.step_spans(marks, parent=chunk, replay=True)

    # ------------------------------------------------------------------
    def _post_lm(self, state: GenState, h_t: torch.Tensor, h_neg: torch.Tensor,
                 neg_slot: torch.Tensor):
        """Everything after the LM forward for one step; `neg_slot` is the 0-d
        int32 slot this step wrote.

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
        # runs on every step, for every row, and merges by is_diff: the JAX
        # engine's lax.cond without a host read (rows that do not diffuse
        # keep their streaming states; on a step where no row diffuses the
        # chunk is zero, as the skipped branch gives it)
        if self.inject_latent_noise:
            # frame index clamped at the last row, like JAX's gather
            f_idx = state.frames.long().clamp(max=state.latent_noise.shape[0] - 1)
            x_init = state.latent_noise[f_idx, torch.arange(b, device=dev)].to(h_t.dtype)
        else:
            x_init = torch.randn((b, cfg.acoustic_vae_dim), generator=state.rng,
                                 dtype=h_t.dtype, device=dev)
        sde_gen = state.rng if gen.algorithm_type.startswith("sde") else None
        self._mark("rest")
        latent = vibevoice.sample_speech_latents(
            p, cfg, self.solver_cfg, self.sched, h_t, h_neg, gen.cfg_scale, x_init,
            sde_generator=sde_gen, timesteps=self.timesteps, mesh=self.tp_mesh)
        self._mark("head")
        scaled = vibevoice.unscale_latents(p, latent)
        if self.use_fused_vocoder or self.use_fused_stages:
            chunk, ac_new = tokenizer.decoder_apply_streaming_fused(
                p["acoustic_decoder"], cfg.acoustic_tokenizer, scaled[:, None, :],
                acoustic_state, fused_packs=p.get("_vocoder_packs"),
                large_packs=p.get("_vocoder_packs_large"))
        else:
            chunk, ac_new = tokenizer.decoder_apply_streaming(
                p["acoustic_decoder"], cfg.acoustic_tokenizer, scaled[:, None, :],
                acoustic_state)
        self._mark("acoustic_decoder")
        if self.use_fused_semantic or self.use_fused_stages:
            sem, sem_new = tokenizer.encoder_apply_streaming_fused(
                p["semantic_encoder"], cfg.semantic_tokenizer, chunk, semantic_state,
                fused_packs=p.get("_semantic_packs"),
                large_packs=p.get("_semantic_packs_large"))
        else:
            sem, sem_new = tokenizer.encoder_apply_streaming(
                p["semantic_encoder"], cfg.semantic_tokenizer, chunk, semantic_state)
        self._mark("semantic_encoder")
        diff_embeds = (connectors.apply(p["acoustic_connector"], latent)
                       + connectors.apply(p["semantic_connector"], sem[:, 0]))
        chunk = torch.where(is_diff.any(), chunk[:, :, 0], 0.0)
        acoustic_state = _where_state(is_diff, ac_new, acoustic_state)
        semantic_state = _where_state(is_diff, sem_new, semantic_state)

        # negative bookkeeping: refresh mode commits this step's slot only on
        # diffusion steps; stale mode commits every step
        commit = is_diff if gen.refresh_negative else ~finished
        ns = neg_slot.long().reshape(1)
        neg_vis = visible[b:]
        neg_vis.index_copy_(1, ns, torch.where(commit[:, None], 1, neg_vis.index_select(1, ns)))
        neg_first_slot = torch.where(commit & ~state.neg_started, neg_slot,
                                     state.neg_first_slot)
        neg_positions = state.neg_positions + commit.to(torch.int32)
        neg_started = state.neg_started | commit

        # per-step slot writes at the device step: audio/emitted clamp at the
        # last slot (the JAX engine's dynamic_update_slice), a token past the
        # end keeps the old value (its scatter drops it)
        slot = step.clamp(max=self.max_steps - 1).long().reshape(1)
        if self.keep_audio:
            state.audio.index_copy_(1, slot, torch.where(is_diff[:, None], chunk, 0.0)
                                    .float()[:, None])
        state.emitted.index_copy_(1, slot, is_diff[:, None])
        state.tokens.index_copy_(1, slot, torch.where(
            step < self.max_steps, next_tok, state.tokens.index_select(1, slot)[:, 0])[:, None])
        frames = state.frames + is_diff.to(torch.int32)

        # next input embeds (ref :582-690)
        tok_embeds = qwen2.embed_rows(p["lm"], next_tok.long()).to(h_t.dtype)
        cur_embeds = torch.where(is_diff[:, None], diff_embeds, tok_embeds)

        new_state = state._replace(
            visible=visible, neg_first_slot=neg_first_slot, neg_positions=neg_positions,
            neg_started=neg_started, cur_embeds=cur_embeds, finished=finished,
            reach_max=reach_max, step=step + 1, acoustic_state=acoustic_state,
            semantic_state=semantic_state, frames=frames, host_step=state.host_step + 1)
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
        generator on the engine's device seeded with 0.  A data-parallel
        engine takes the global batch and keeps this rank's rows (the voice
        inputs' rows likewise, `latent_noise` on its axis 1)."""
        args = (input_ids, attention_mask, speech_input_mask, speech_tensors,
                speech_frame_masks, generator, voice_latents, latent_noise)
        tr = self.tracer
        if tr is None:
            return self._prefill(*args)
        self._read_replay(tr)
        with tr.span("engine.prefill.host") as host:
            begin, self._span = tr.stamp(), tr.new_id()
            try:
                out = self._prefill(*args)
            finally:
                span, self._span = self._span, None
            tr.device_span("engine.prefill", begin, tr.stamp(), parent=host, id=span)
        return out

    def _prefill(self, input_ids, attention_mask, speech_input_mask, speech_tensors,
                 speech_frame_masks, generator, voice_latents, latent_noise):
        p, cfg, gen, dev = self.params, self.cfg, self.gen, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def t(x, dtype=None):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

        input_ids = t(input_ids, torch.int64)
        if tuple(input_ids.shape) != (self.global_batch, self.prompt_len):
            raise ValueError(f"engine built for [{self.global_batch}, {self.prompt_len}] "
                             f"prompts, got {tuple(input_ids.shape)}")
        attention_mask = t(attention_mask, torch.int32)
        speech_input_mask = t(speech_input_mask, torch.bool)
        if self.dp > 1:
            input_ids, attention_mask, speech_input_mask = (
                self._rows(x) for x in (input_ids, attention_mask, speech_input_mask))
            speech_tensors, speech_frame_masks, voice_latents = (
                None if x is None else self._rows(t(x))
                for x in (speech_tensors, speech_frame_masks, voice_latents))
            if latent_noise is not None:
                latent_noise = self._rows(t(latent_noise), dim=1)
            generator = self._rank_generator(generator)
        b, t0 = input_ids.shape
        dec = cfg.decoder

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

        # ONE unified-cache allocation (rows [:B] positive, [B:] negative);
        # once the step is captured, the graph's own cache, zeroed
        if self._static is not None:
            cache = self._static.cache
            for buf in cache:
                if buf is not None:
                    buf.zero_()
        else:
            cache = qwen2.kv_cache_init(dec, 2 * b, self.cache_len, self.dtype,
                                        quantized=self.kv_quant, device=dev,
                                        mesh=self.tp_mesh)

        # positive prefill into rows [:B]; the flash path attends the prompt's
        # own k/v and needs no [B, 1, T, S] bias, so its memory stays linear in T
        bias = None
        if not self.use_flash_prefill:
            bias = torch.full((b, 1, t0, self.cache_len), -1e9, dtype=torch.float32, device=dev)
            bias[:, :, :, :t0] = qwen2.causal_bias(attention_mask, t0)
        pos = qwen2.positions_from_mask(attention_mask)
        hidden, cache = qwen2.forward(p["lm"], dec, embeds, pos, bias, cache=cache,
                                      write_pos=0, pad_mask=attention_mask,
                                      use_flash=self.use_flash_prefill, mesh=self.tp_mesh)
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
                                      neg_bias, cache=cache, write_pos=0, batch_offset=b,
                                      mesh=self.tp_mesh)

        visible = torch.zeros((2 * b, self.cache_len), dtype=torch.int32, device=dev)
        visible[:b, :t0] = attention_mask

        init_len = attention_mask.sum(dim=-1).to(torch.int32)
        max_steps_ps = torch.minimum(
            torch.full_like(init_len, self.max_steps),
            (gen.max_length_times * init_len.float()).to(torch.int32))

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = GenState(
            cache=cache, visible=visible, write_pos=torch.full((), t0, dtype=torch.int32,
                                                               device=dev),
            pos_positions=init_len.clone(),
            neg_first_slot=zeros((b,), torch.int32),
            neg_positions=zeros((b,), torch.int32),
            neg_started=zeros((b,), torch.bool),
            cur_embeds=ss_embed[:, 0],
            finished=zeros((b,), torch.bool),
            reach_max=zeros((b,), torch.bool),
            step=zeros((), torch.int32), max_step_per_sample=max_steps_ps,
            acoustic_state=tokenizer.decoder_state_init(cfg.acoustic_tokenizer, b, self.dtype,
                                                        device=dev),
            semantic_state=tokenizer.encoder_state_init(cfg.semantic_tokenizer, b, self.dtype,
                                                        device=dev),
            frames=zeros((b,), torch.int32),
            audio=zeros((b, self.max_steps if self.keep_audio else 1, self.hop), torch.float32),
            emitted=zeros((b, self.max_steps), torch.bool),
            tokens=zeros((b, self.max_steps), torch.int32),
            rng=generator,
            latent_noise=(t(latent_noise).clone() if latent_noise is not None
                          else zeros((1, b, cfg.acoustic_vae_dim), self.dtype)),
            host_step=0,
        )
        # at step 0 the negative stream's "just-written" kv is the slot-0 pre-seed
        return self._eager_marked(self._post_lm, state, h_last, h_neg0[:, 0],
                                  zeros((), torch.int32))

    def _rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This data rank's equal part of axis `dim`."""
        n = x.shape[dim]
        if n % self.dp:
            raise ValueError(f"{n} rows do not split over data axis {self.dp}")
        n //= self.dp
        return x.narrow(dim, self.dp_index * n, n)

    def _rank_generator(self, generator: torch.Generator) -> torch.Generator:
        """This data rank's generator: one seed drawn from the caller's (the
        same on every rank), mixed with the rank's index, so that the ranks'
        draws differ."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        mixed = (seed + 0x9E3779B97F4A7C15 * (self.dp_index + 1)) % 2 ** 63
        return torch.Generator(device=self.device).manual_seed(mixed)

    def gather(self, state: GenState) -> Gathered:
        """The per-row results of every data rank in global row order (one
        all-gather over the data group per tensor; every rank must call it).
        Without data parallelism, this engine's own."""
        fields = (state.tokens, state.audio, state.emitted, state.frames, state.finished,
                  state.reach_max)
        if self.dp == 1:
            return Gathered(*fields)
        out = []
        for x in fields:
            # bool through uint8: not every backend reduces or gathers bool
            y = self.mesh.all_gather(x.to(torch.uint8) if x.dtype == torch.bool else x,
                                     "data", dim=0)
            out.append(y.bool() if x.dtype == torch.bool else y)
        return Gathered(*out)

    def all_finished(self, finished, stop: bool) -> bool:
        """Whether generation ends: every row has finished, or `stop` is set.
        Under data parallelism every rank's rows and every rank's `stop` count
        (one reduction over the data group), so all ranks end on the same
        chunk and go on to the same collectives."""
        done = bool(np.all(finished))
        if self.dp == 1:
            return done or stop
        flags = torch.tensor([0 if done else 1, int(stop)], dtype=torch.int32,
                             device=self.device)
        self.mesh.all_reduce(flags, "data", op="max")
        return int(flags[0]) == 0 or int(flags[1]) == 1

    # ------------------------------------------------------------------
    def _step(self, state: GenState):
        """One decode step, safe to capture: a combined [2B] forward over the
        unified cache.  Both streams write this step's kv at slot
        `write_pos`; the negative stream's history is carried by the
        visibility mask."""
        p, cfg = self.params, self.cfg
        b = state.cur_embeds.shape[0]
        wp = state.write_pos
        slot = wp.long().reshape(1)

        # each row sees its committed history plus the slot written now
        vis_step = state.visible.clone()
        vis_step.index_fill_(1, slot, 1)

        embeds2 = torch.cat([state.cur_embeds, state.cur_embeds], dim=0)[:, None, :]
        positions2 = torch.cat([state.pos_positions, state.neg_positions])[:, None]

        decode_ctx, bias = None, None
        if self.use_flash_decode:
            decode_ctx = (vis_step, (wp + 1).repeat(2 * b))
        else:
            bias = qwen2.decode_bias(vis_step)
        hidden, _ = qwen2.forward(p["lm"], cfg.decoder, embeds2, positions2, bias,
                                  cache=state.cache, write_pos=wp, decode_ctx=decode_ctx,
                                  mesh=self.tp_mesh)
        self._mark("lm")
        state.visible[:b].index_fill_(1, slot, 1)
        state = state._replace(write_pos=wp + 1, pos_positions=state.pos_positions + 1)
        return self._post_lm(state, hidden[:b, 0], hidden[b:, 0], neg_slot=wp)

    def _check_room(self, state: GenState, n: int):
        """Raise unless the cache holds `n` more steps (from the host mirror)."""
        last = self.prompt_len + state.host_step - 1 + n - 1  # the last step's write_pos
        if last >= self.cache_len:
            raise RuntimeError(f"KV cache full ({self.cache_len} slots)")

    @torch.no_grad()
    def step(self, state: GenState):
        """One decode step (on the card a replay of the captured step, unless
        the engine is `eager`)."""
        if self.use_graph:
            state, outs = self.decode_chunk(state, 1)
            return state, StepOutput(*(x[0] for x in outs))
        self._check_room(state, 1)
        return self._eager_marked(self._step, state)

    @torch.no_grad()
    def decode_chunk(self, state: GenState, n: int):
        """`n` steps; the outputs are stacked on a leading [n] axis.  On the
        card each step is a replay of the captured step (the first call after
        the engine's first prefill captures it), with no read from the
        device."""
        tr = self.tracer
        if tr is None:
            return self._decode_chunk(state, n)
        tr.poll()
        self._read_replay(tr)
        replays, captures = self.replays, self.captures
        begin, self._span = tr.stamp(), tr.new_id()
        try:
            state, outs = self._decode_chunk(state, n)
        finally:
            span, self._span = self._span, None
        tr.device_span("engine.chunk", begin, tr.stamp(), parent=tr.current(), id=span)
        tr.count("chunks")
        tr.count("replays", self.replays - replays)
        tr.count("captures", self.captures - captures)
        if self.replays > replays and self._graph_marks is not None:
            self._unread = span
        return state, outs

    def _decode_chunk(self, state: GenState, n: int):
        if not self.use_graph:
            outs = []
            for _ in range(n):
                state, out = self.step(state)
                outs.append(out)
            return state, StepOutput(*(torch.stack(xs) for xs in zip(*outs)))
        self._check_room(state, n)
        b, dev = self.batch, self.device
        outs = StepOutput(
            token=torch.empty((n, b), dtype=torch.int32, device=dev),
            audio_chunk=torch.empty((n, b, self.hop), dtype=self.dtype, device=dev),
            emitted=torch.empty((n, b), dtype=torch.bool, device=dev),
            finished=torch.empty((n, b), dtype=torch.bool, device=dev))
        static = self._bind(state)
        first = 0
        if self.graph is None:
            self._capture(static, outs)
            first = 1
        for i in range(first, n):
            self.graph.replay()
            self.replays += 1
            for dst, src in zip(outs, self._graph_out):
                dst[i].copy_(src)
        return static._replace(host_step=state.host_step + n), outs

    def _bind(self, state: GenState) -> GenState:
        """The engine's static state holding `state`: its tensors become the
        static buffers on the first call, and are copied into them on a later
        request's first call; the state's generator is copied into the one
        the graph draws from."""
        if self._rng is None:
            self._rng = torch.Generator(device=self.device)
        if state.rng is not self._rng:
            self._rng.set_state(state.rng.get_state())
            state = state._replace(rng=self._rng)
        if self._static is None:
            self._static = state
        elif state.visible is not self._static.visible:
            _copy_into(self._static, state)
        return self._static

    def _step_into(self, static: GenState) -> StepOutput:
        """One step whose new state is copied back into `static`: the body
        of the graph."""
        new, out = self._step(static)
        _copy_into(static, new)
        return out

    def _capture(self, static: GenState, outs: StepOutput):
        """Warm one step up on a side stream (a real step, written to step 0
        of `outs`), then capture one step in a CUDA graph on that stream,
        with the state's generator registered so each replay draws anew.  A
        failure raises: there is no eager fallback."""
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for dst, src in zip(outs, self._eager_marked(self._step_into, static)):
                dst[0].copy_(src)
        torch.cuda.current_stream(dev).wait_stream(stream)
        tr, marks = self.tracer, None
        t0 = time.perf_counter_ns()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(self._rng)
        with torch.cuda.graph(graph, stream=stream):
            if tr is None:
                out = self._step_into(static)
            else:
                with self._marking(_graph_event) as marks:
                    out = self._step_into(static)
        graph.instantiate()
        t1 = time.perf_counter_ns()
        self.captures += 1
        self.capture_s = (t1 - t0) / 1e9
        if tr is not None:
            tr.add("engine.capture", t0, t1, parent=tr.current())
        self.graph, self._graph_out, self._graph_marks = graph, out, marks


def _graph_event() -> torch.cuda.Event:
    """A timing event recorded on the capturing stream: a node of the graph
    (`external`), recorded again at each replay."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class GenerationResult(NamedTuple):
    tokens: np.ndarray          # [B, steps] generated control tokens
    audio: list                 # list of [T_b] float32 waveforms (or None)
    reach_max: np.ndarray       # [B] bool
    steps: int


_NO_SPAN = contextlib.nullcontext()


def _untraced(name: str, request: bool = False):
    """`Tracer.span`'s stand-in when nothing traces: one shared null context."""
    return _NO_SPAN


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
    show_progress: bool = False,
    on_step=None,
) -> GenerationResult:
    """Host-side loop (ref generate :328-710).  With a streamer, a
    `stop_check_fn` or `on_step` attached it advances `stream_chunk` steps per
    chunk and hands each step's output to them; otherwise it advances in
    `check_every`-step chunks and only reads the finished flags between them.

    `on_step(out: StepOutput)` gets numpy views once per decode step — the
    engine's emitted-frame clock.  `show_progress` shows a tqdm bar over the
    decode steps where tqdm is installed.

    With a data-parallel engine every rank calls it with the global batch:
    the loop stops when every rank's rows have finished or any rank's
    `stop_check_fn` fires, the result is in global row order, a streamer
    (sized for the global batch) gets this rank's rows under their global
    indices, and `on_step` sees this rank's rows.

    With a tracer on the engine (`Engine.set_tracer`) the call is a request
    under a host span "generate", with host spans around each chunk's
    enqueue ("engine.decode_chunk"), its read to the host ("generate.read"),
    the callbacks ("generate.feed"), the stop test ("generate.stop_check") and
    the results' gather and copy ("generate.finish")."""
    tr = getattr(engine, "tracer", None)
    span = _untraced if tr is None else tr.span
    with span("generate", request=True):
        state, out = engine.prefill(input_ids, attention_mask, speech_input_mask,
                                    speech_tensors, speech_frame_masks, generator,
                                    voice_latents, latent_noise)
        b = engine.global_batch
        row0 = engine.dp_index * engine.batch  # this rank's first global row
        steps_done = 1
        bar = None
        if show_progress:
            try:
                from tqdm import tqdm
                bar = tqdm(total=engine.max_steps - 1, desc="Generating", ncols=100)
            except ImportError:
                pass

        def _feed(o: StepOutput):
            if on_step is not None:
                on_step(o)
            if audio_streamer is None:
                return
            if o.emitted.any():
                idx = np.nonzero(o.emitted)[0]
                audio_streamer.put(o.audio_chunk[idx], row0 + idx)
            if o.finished.any():
                audio_streamer.end(row0 + np.nonzero(o.finished)[0])

        with span("generate.read"):
            out_np = StepOutput(*(_np(x) for x in out))
        with span("generate.feed"):
            _feed(out_np)
        finished = out_np.finished
        per_step = audio_streamer is not None or stop_check_fn is not None or on_step is not None
        # one read from the device per chunk: its outputs, or its finished flags
        while steps_done < engine.max_steps:
            with span("generate.stop_check"):
                stop = per_step and stop_check_fn is not None and bool(stop_check_fn())
                if engine.all_finished(finished, stop):
                    break
            n = min(max(1, stream_chunk) if per_step else check_every,
                    engine.max_steps - steps_done)
            with span("engine.decode_chunk"):
                state, outs = engine.decode_chunk(state, n)
            steps_done += n
            if bar is not None:
                bar.update(n)
            if per_step:
                with span("generate.read"):
                    outs_np = StepOutput(*(_np(x) for x in outs))
                with span("generate.feed"):
                    for i in range(n):
                        _feed(StepOutput(*(x[i] for x in outs_np)))
                finished = outs_np.finished[-1]
            else:
                with span("generate.read"):
                    finished = _np(state.finished)

        if bar is not None:
            bar.close()
        if audio_streamer is not None:
            audio_streamer.end()

        with span("generate.finish"):
            rows = engine.gather(state)
            frames = _np(rows.frames)
            if engine.keep_audio:
                audio_buf, emitted_map = _np(rows.audio), _np(rows.emitted)
                audio = [audio_buf[i][emitted_map[i]].reshape(-1) if frames[i] > 0 else None
                         for i in range(b)]
            else:
                audio = [None] * b  # streaming consumers got the chunks already
            tokens = _np(rows.tokens)[:, : min(state.host_step, engine.max_steps)]
            reach_max = _np(rows.reach_max)
    return GenerationResult(tokens=tokens, audio=audio, reach_max=reach_max, steps=steps_done)


__all__ = ["Engine", "GenerationConfig", "GenState", "Gathered", "StepOutput",
           "GenerationResult", "generate", "select_token", "resolve_device"]
