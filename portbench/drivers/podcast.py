"""Offline long-form podcasts: a batch of episodes through the port's engine.

Set-up makes the weights and the first batch from the seed, builds the
`Engine` as the pipeline does for the traffic's batch, prompt bucket and
episode length (forced diffusion and injected x_T, as the benchmark needs),
prefills the first batch and captures the step: the prefill is paid once an
episode, as a user of the batch CLI pays it, and the window continues those
episodes.  The window is `engine.generate.generate` on that engine, stopped by
its `stop_check_fn` at the window's end; a batch that finishes inside it is
followed by the next, whose prefill then runs inside the window.

`audio_s_per_s` is every audio second emitted in the window over the
window's wall seconds; the window closes when the stop fires, with the last
chunk's outputs on the host (what `generate` does after it, once an episode,
is outside the window, as the prefill of the first batch is).  `setup_s` is
process start to the window's start.
With `--trace 1`, CUDA events around each prefill and `decode_chunk` give the
device's busy share, and the per-layer readers run after the window.
Then the program's outputs are judged against the plain reference
(`portbench/check.py`).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import check, traffic, weights
from ..harness import ROOT, Outcome, Run
from ..reference import configs as RC
from ..reference import model as R

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Spans:
    """CUDA events recorded on the stream around calls, read once at the end."""

    def __init__(self, device):
        self.device = device
        self.events: List[tuple] = []

    def run(self, name, fn, *a, **k):
        if self.device.type != "cuda":
            return fn(*a, **k)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **k)
        e1.record()
        self.events.append((name, e0, e1))
        return out

    def seconds(self) -> Dict[str, float]:
        torch.cuda.synchronize(self.device)
        out: Dict[str, float] = {}
        for name, e0, e1 in self.events:
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1) / 1e3
        return out


class EngineProxy:
    """The engine as `generate` sees it in the window: its first prefill
    hands back the state that set-up prefilled, and with `spans` each prefill
    and `decode_chunk` is wrapped in CUDA events.  Keeps the newest state."""

    def __init__(self, engine, first=None, spans: Optional[Spans] = None, before_prefill=None):
        self._engine, self._first, self._spans = engine, first, spans
        self._before_prefill = before_prefill
        self.state = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _call(self, name, fn, *a, **k):
        return fn(*a, **k) if self._spans is None else self._spans.run(name, fn, *a, **k)

    def prefill(self, *a, **k):
        if self._first is not None:
            out, self._first = self._first, None
        else:
            if self._before_prefill is not None:
                self._before_prefill(self.state)
            out = self._call("prefill", self._engine.prefill, *a, **k)
        self.state = out[0]
        return out

    def decode_chunk(self, state, n):
        self.state, outs = self._call("decode_chunk", self._engine.decode_chunk, state, n)
        return self.state, outs


class HeadTap:
    """Holds the program's own CFG sampling of one step: its inputs to
    `vibevoice.sample_speech_latents` (both streams' hidden states, x_T) and
    the latent it returns, the per-step modulations it takes from
    `diffusion_head.precompute_modulations`, and each solver step's sample in
    and out of `dpm_solver.step`.  The tensors of the captured step are
    kept, so after each replay they hold that replay's values, and no later
    call (a prefill) replaces them; without a capture, those of the newest
    sampling.  Holding them adds no operation to the step."""

    def __init__(self):
        from vibevoice_tpu_torch.models import diffusion_head, vibevoice
        from vibevoice_tpu_torch.schedule import dpm_solver
        self._at = [(vibevoice, "sample_speech_latents", self._sample),
                    (diffusion_head, "precompute_modulations", self._mods),
                    (dpm_solver, "step", self._step)]
        self._real = {name: getattr(mod, name) for mod, name, _ in self._at}
        for mod, name, fn in self._at:
            setattr(mod, name, fn)
        self._open: Optional[dict] = None
        self.seen: Optional[dict] = None
        self.frozen = False

    def _sample(self, *a, **k):
        self._open = {"mods": None, "steps": []}
        try:
            out = self._real["sample_speech_latents"](*a, **k)
            rec = self._open
        finally:
            self._open = None

        def arg(i, name):
            return a[i] if len(a) > i else k[name]
        capturing = out.is_cuda and torch.cuda.is_current_stream_capturing()
        if capturing or not self.frozen:
            self.seen = dict(rec, cond=arg(4, "condition"), neg=arg(5, "neg_condition"),
                             latent=out)
            self.frozen = capturing
        return out

    def _mods(self, *a, **k):
        out = self._real["precompute_modulations"](*a, **k)
        if self._open is not None:
            self._open["mods"] = out
        return out

    def _step(self, *a, **k):
        out = self._real["step"](*a, **k)
        if self._open is not None:
            self._open["steps"].append((a[5] if len(a) > 5 else k["sample"], out[0]))
        return out

    def read(self) -> dict:
        """The held sampling as `check.head_observations` gives it, copied;
        the tap lets go of the step's own tensors."""
        seen, self.seen = self.seen, None
        obs = check.head_observations(seen)
        return {"cond": obs["cond"].clone(),
                "steps": [(x.clone(), y.clone()) for x, y in obs["steps"]],
                "mods": ([m.clone() for m in obs["mods"][0]], obs["mods"][1].clone())}

    def close(self):
        for mod, name, _ in self._at:
            setattr(mod, name, self._real[name])


def snapshot(st) -> dict:
    """The small part of a state that the next step reads (the cache only
    grows, so its slots below `write_pos` are read afterwards)."""
    def clone_states(states):
        return [type(s)(*(x.clone() for x in s)) for s in states]
    return {"cur_embeds": st.cur_embeds.clone(), "pos_positions": st.pos_positions.clone(),
            "neg_positions": st.neg_positions.clone(), "visible": st.visible.clone(),
            "frames": st.frames.clone(), "write_pos": int(st.write_pos), "step": int(st.step),
            "host_step": st.host_step,
            "acoustic_state": clone_states(st.acoustic_state),
            "semantic_state": clone_states(st.semantic_state)}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generation_config(G, ids: dict, tr: dict):
    return G.GenerationConfig(
        speech_start_id=ids["speech_start"], speech_end_id=ids["speech_end"],
        speech_diffusion_id=ids["speech_diffusion"], eos_id=ids["eos"],
        cfg_scale=tr["cfg_scale"], ddpm_steps=tr["ddpm_steps"],
        algorithm_type=tr["algorithm_type"], force_diffusion=True,
        # every row runs its episode to max_steps
        max_length_times=64.0)


def _interleave(cand, want):
    """(cand_start, want_start, cand_end, want_end), as `check.numbers` takes them."""
    return cand[0], want[0], cand[1], want[1]


def run(rn: Run) -> Outcome:
    tap = HeadTap()
    try:
        return _run(rn, tap)
    finally:
        tap.close()


def _run(rn: Run, tap: HeadTap) -> Outcome:
    from vibevoice_tpu_torch.configs import config_from_json
    from vibevoice_tpu_torch.engine import generate as G

    t0 = rn.hooks.get("t0", time.perf_counter())
    cell, tr, dev = rn.cell, rn.cell.traffic, rn.device
    cfg = RC.config_from_dict(cell.config_file)
    pcfg = config_from_json(os.path.join(ROOT, cell.config["file"]))
    ids = cell.config_file["token_ids"]
    dtype = DTYPES[cell.config_file["precision"]]
    b, hop = tr["batch"], cfg.speech_compress_ratio
    notes: List[str] = []

    # ---- set-up: weights, the first batch, the engine, its prefill and capture
    p = weights.make_weights(cfg, traffic.sub_seed(rn.seed, "weights"), dev, dtype)
    params = rn.hooks["params"](p, pcfg) if "params" in rn.hooks else p
    batch0 = traffic.podcast_batch(tr, ids, cfg, rn.seed, 0, dev, dtype)
    engine = G.Engine(params, pcfg, generation_config(G, ids, tr), max_steps=tr["max_steps"],
                      batch=b, prompt_len=tr["prompt_len"], dtype=dtype,
                      inject_latent_noise=True, device=dev)

    def prefill(bt, eng):
        return eng.prefill(bt.ids, bt.attention_mask, bt.speech_mask, bt.speech_tensors,
                           bt.frame_masks, torch.Generator(device=dev).manual_seed(
                               bt.generator_seed), latent_noise=bt.latent_noise)

    state, out0 = prefill(batch0, engine)
    state, outs = engine.decode_chunk(state, 1)  # on the card: the capture
    first_frames = [out0.audio_chunk.float().cpu()]
    sync(dev)
    setup_s = time.perf_counter() - t0

    # the prompt's cache of the first batch, read before a later prefill
    # writes over it (else after the window)
    rng = np.random.default_rng(traffic.sub_seed(rn.seed, "check rows"))
    start_rows = sorted(rng.choice(b, size=tr["check_rows"], replace=False).tolist())
    p_len = tr["prompt_len"]
    start_kv: list = []

    def read_start_kv(st):
        if not start_kv:
            start_kv.extend(
                (st.cache.k[:, r, p_len - batch0.lengths[r]:p_len].clone(),
                 st.cache.v[:, r, p_len - batch0.lengths[r]:p_len].clone()) for r in start_rows)

    # ---- the window
    spans = Spans(dev) if rn.trace else None
    proxy = EngineProxy(engine, (state, G.StepOutput(*(x[0] for x in outs))), spans,
                        before_prefill=read_start_kv)
    count = {"frames": 0, "skip": 1, "bad_rows": set()}

    def on_step(o):
        if count["skip"]:  # the prefill's output replayed from set-up
            count["skip"] -= 1
            return
        count["frames"] += int(o.emitted.sum())
        bad = o.emitted & ~np.isfinite(o.audio_chunk).all(axis=1)
        count["bad_rows"].update((count["batch"] * b + np.nonzero(bad)[0]).tolist())

    snap: dict = {}
    stopped: list = []

    def stop_check():
        if snap:  # the last chunk's outputs are on the host: the window closes
            stopped.append(time.perf_counter())
            return True
        if time.perf_counter() < deadline:
            return False
        snap.update(snapshot(proxy.state))  # the window's last chunk follows
        return False

    t_start = time.perf_counter()
    deadline = t_start + rn.seconds
    index = 0
    while True:
        count["batch"] = index
        bt = batch0 if index == 0 else traffic.podcast_batch(tr, ids, cfg, rn.seed, index,
                                                             dev, dtype)
        G.generate(proxy, bt.ids, bt.attention_mask, bt.speech_mask, bt.speech_tensors,
                   bt.frame_masks, torch.Generator(device=dev).manual_seed(bt.generator_seed),
                   latent_noise=bt.latent_noise, stop_check_fn=stop_check, on_step=on_step)
        if snap:
            break
        index += 1
    window_s = stopped[0] - t_start
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    st = proxy.state

    # ---- what the check reads of the program, before anything else runs
    head = tap.read()
    k, wp = snap["step"], snap["write_pos"]
    end_rows = list(range(b))
    read_start_kv(st)
    seqs = end_rows + [b + r for r in end_rows]
    # the decoder's first conv keeps its last inputs: the unscaled latents of
    # the last steps, the compared step's among them
    after = st.host_step - snap["host_step"]
    ctx = st.acoustic_state[0].buf
    if not 0 < after <= ctx.shape[1]:
        raise RuntimeError(f"{after} steps ran after the window's last check; the compared "
                           f"step's latent is no longer in the decoder's context")
    obs_start, obs_end = check.program_observations(
        [first_frames[0][start_rows]], start_kv,
        latent=ctx[:, ctx.shape[1] - after].clone(), audio=st.audio[:, k].clone(),
        kv=(st.cache.k[:, seqs, wp].clone(), st.cache.v[:, seqs, wp].clone()),
        kv_next=(st.cache.k[0, seqs, wp + 1].clone(), st.cache.v[0, seqs, wp + 1].clone()),
        head=head)
    # the x_T the benchmark handed in for the window's last step
    f_last = (st.frames.long() - 1).clamp(0, bt.latent_noise.shape[0] - 1)
    head["x_T"] = bt.latent_noise[f_last.to(bt.latent_noise.device),
                                  torch.arange(b, device=bt.latent_noise.device)]
    vis = [torch.nonzero(snap["visible"][j])[:, 0] for j in seqs]
    past_k = [st.cache.k[:, j, vis[i]].clone() for i, j in enumerate(seqs)]
    past_v = [st.cache.v[:, j, vis[i]].clone() for i, j in enumerate(seqs)]

    per_layer, busy_s, breakdown = {}, None, None
    if rn.trace:
        busy = spans.seconds()
        busy_s = sum(busy.values())
        per_layer = rn.read_layers({
            "engine": engine, "state": st, "cfg": cfg, "traffic": tr, "device": dev,
            "dtype": dtype, "busy_s": busy_s, "window_s": window_s, "notes": notes})
        breakdown = {"device_ops": [[f"{n} (CUDA events around the call)", s]
                                    for n, s in sorted(busy.items(), key=lambda x: -x[1])],
                     "idle_gaps": [["host between calls: generate's per-chunk read of the "
                                    "outputs and its callbacks", window_s - busy_s]]}

    # ---- the reference, once the program's state is freed
    del engine, proxy, st, state, outs, out0, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    R.plain_precision()
    sv = R.solver(cfg, tr["algorithm_type"], tr["ddpm_steps"])

    def reference(weights_tree):
        with torch.no_grad():
            s = check.start_outputs(weights_tree, cfg, sv, tr["cfg_scale"], ids, batch0,
                                    tr["speakers"], start_rows, 1, dtype)
            e = check.end_outputs(weights_tree, cfg, sv, tr["cfg_scale"], snap, end_rows,
                                  lambda li, j: (past_k[j][li], past_v[j][li]),
                                  bt.latent_noise, obs_end["latent"], obs_end["audio"],
                                  head)
        return s, e

    want_start, want_end = reference(p)
    compared = check.numbers(obs_start, want_start, obs_end, want_end)
    fp8_reference = {}
    if rn.hooks.get("fp8_reference"):  # the reference with float8 weights in the program's place
        fp8_reference = check.numbers(*_interleave(reference(check.fp8_weights(p)),
                                                   (want_start, want_end)))
    attempted = b * (index + 1)
    return Outcome(
        end_to_end={"audio_s_per_s": count["frames"] * hop / traffic.SAMPLE_RATE / window_s,
                    "setup_s": setup_s},
        per_layer=per_layer, attempted=attempted, failed=len(count["bad_rows"]),
        compared=compared, fp8_reference=fp8_reference, memory_peak_bytes=peak, busy_s=busy_s,
        window_s=window_s, breakdown=breakdown,
        notes=[f"window {window_s:.4f} s, {count['frames']} frames emitted, {index + 1} "
               f"batch(es), compared step {k} at slot {wp}; set-up {setup_s:.4f} s"] + notes)


__all__ = ["run", "EngineProxy", "HeadTap", "Spans", "snapshot"]
