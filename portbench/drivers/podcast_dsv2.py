"""Offline long-form podcasts on a VibeVoice whose LM is DeepSeek-V2 (latent
attention, experts): `podcast.py`'s cell on the port's DeepSeek-V2 decoder.

Set-up, the window and the metrics are `podcast.py`'s: the weights and the
first batch from the seed, the engine as the pipeline builds it (forced
diffusion, injected x_T), its prefill and capture, then
`engine.generate.generate` continuing the episodes until `stop_check_fn`
fires.  The window's last chunk is run as its steps but one and then its last
step alone, with the state snapshotted between them (`LastStepProxy`), so
that every number of the check reads that one step.

What decides `correct` (each the worst row's relative L2 error against the
plain float32 reference `reference/deepseek_v2.py`, limits in
`limits/<workload>.json`):
  start_kv_rel       the latent cache the prefill wrote for the prompt, every
                     layer (c_kv and the roped k_pe of each token), against
                     the reference's forward over the prompt's inputs;
  end_hidden_rel     the LM's final hidden state of the compared step (both
                     CFG streams, as the head took them), against the
                     reference's full forward over the program's cached
                     latents: the number that holds absorbed decode, the
                     MLA kernel and the experts to the published form;
  end_kv_rel         the latent slots that step wrote, every layer;
  end_moe_rel        every expert layer's output in that step (routed and
                     shared experts), against the reference's expert layer
                     (`moe`: a loop over each token's experts) on the
                     program's own input to it (`ExpertTap`);
  end_routed_rel     the routed experts' weighed sum inside it, likewise:
                     the two hold the router and the experts to the published
                     form with nothing before them in between;
  end_head_step_rel, end_decoder_rel, end_semantic_rel: as in `check.py`
                     (the semantic number reads the next input's first-layer
                     latent slot).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check, traffic
from .. import weights as W
from ..harness import ROOT, Outcome, Run
from ..reference import connectors, tokenizer
from ..reference import deepseek_v2 as RD
from ..reference import model as R
from .podcast import DTYPES, EngineProxy, HeadTap, Spans, generation_config, snapshot, sync


def make_weights(cfg, seed: int, device, dtype=torch.bfloat16):
    """`weights.make_weights` over the DeepSeek-V2 tree (`RD.param_spec`):
    every leaf a view into one buffer in `dtype`, drawn from `seed` in
    chunks, then one multiply-add per distinct (mean, std)."""
    spec = RD.param_spec(cfg)
    leaves = W._leaves(spec)
    groups = sorted({(leaf.mean, leaf.std) for _, leaf in leaves})
    order = sorted(leaves, key=lambda pl: groups.index((pl[1].mean, pl[1].std)))
    total = sum(int(torch.Size(leaf.shape).numel()) for _, leaf in order)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for off in range(0, total, W.CHUNK):
        n = min(W.CHUNK, total - off)
        torch.randn(n, generator=gen, dtype=dtype, device=device, out=buf[off:off + n])
    values, off, spans = {}, 0, {}
    for path, leaf in order:
        n = int(torch.Size(leaf.shape).numel())
        values[path] = buf[off:off + n].view(leaf.shape)
        lo, hi = spans.get((leaf.mean, leaf.std), (off, off))
        spans[(leaf.mean, leaf.std)] = (min(lo, off), off + n)
        off += n
    for (mean, std), (lo, hi) in spans.items():
        buf[lo:hi].mul_(std).add_(mean)
    params = W._fill(spec, values)
    params["speech_scaling_factor"] = torch.tensor(R.SPEECH_SCALING, device=device)
    params["speech_bias_factor"] = torch.tensor(R.SPEECH_BIAS, device=device)
    return params


class LastStepProxy(EngineProxy):
    """`EngineProxy` that, once `split` is set, runs the next chunk as its
    steps but one, snapshots the state into `snap`, then runs its last step."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.split, self.snap = False, {}

    def decode_chunk(self, state, n):
        if not self.split:
            return super().decode_chunk(state, n)
        self.split = False
        parts = []
        if n > 1:
            state, outs = super().decode_chunk(state, n - 1)
            parts.append(outs)
        self.snap.update(snapshot(self.state))
        state, outs = super().decode_chunk(state, 1)
        parts.append(outs)
        return state, type(outs)(*(torch.cat(xs) for xs in zip(*parts)))


def prompt_rows(p, cfg, batch, speakers: int, rows, draw_dtype):
    """Each of `rows`' prompt embeddings [T_r, H] (real tokens only), the
    voice prompts sampled as the prefill samples them (`check.start_outputs`)."""
    dev = batch.latent_noise.device
    n_voices = batch.speech_tensors.shape[0]
    frames = batch.frame_masks.shape[1]
    gen = torch.Generator(device=dev).manual_seed(batch.generator_seed)
    std = torch.randn(n_voices, generator=gen, dtype=draw_dtype, device=dev).float()
    eps = torch.randn((n_voices, frames, cfg.acoustic_vae_dim), generator=gen,
                      dtype=draw_dtype, device=dev).float()
    fix = cfg.acoustic_tokenizer.fix_std / 0.8
    enc = R.to_f32(p["acoustic_encoder"])
    out = []
    for r in rows:
        vidx = list(range(r * speakers, (r + 1) * speakers))
        mean = torch.cat([tokenizer.encoder_apply(enc, cfg.acoustic_tokenizer,
                                                  batch.speech_tensors[i][None, :, None].float())
                          for i in vidx])
        lat = mean + (std[vidx] * fix)[:, None, None] * eps[vidx]
        real = torch.as_tensor(batch.attention_mask[r] == 1)
        out.append(R.prompt_embeds(p, R.Prompt(
            ids=torch.as_tensor(batch.ids[r])[real].to(dev),
            speech_mask=torch.as_tensor(batch.speech_mask[r])[real].to(dev),
            voice_frames=R.scale_latents(lat).reshape(-1, cfg.acoustic_vae_dim))))
    return out


def end_outputs(p, cfg, sv, cfg_scale, snap, rows, past, program_latent, program_audio,
                head, wt=None) -> Dict:
    """One step of `rows` from the program's state `snap` (`check.end_outputs`
    with this LM): the final hidden states [2n, H] and new slots [L, 2n, C]
    of both streams, the decoder's chunk from `program_latent`, the next
    input's first-layer slot from `program_audio` and that latent, and the
    head's steps and modulations from `head`.  `wt` transforms the weights
    (the float8 reference)."""
    dec = cfg.decoder
    rows = list(rows)
    x = snap["cur_embeds"][rows].float()
    positions = ([int(snap["pos_positions"][r]) for r in rows]
                 + [int(snap["neg_positions"][r]) for r in rows])
    h, new = RD.lm_step(p["lm"], dec, torch.cat([x, x]), positions, past, wt)
    speech = R.speech_params_f32(p) if wt is None else wt(R.speech_params_f32(p))
    ac = R.states_rows(snap["acoustic_state"], rows)
    se = R.states_rows(snap["semantic_state"], rows)
    lat = program_latent.float().to(x.device)
    chunk, _ = tokenizer.decoder_apply_streaming(speech["acoustic_decoder"],
                                                 cfg.acoustic_tokenizer, lat[:, None], ac)
    sem, _ = tokenizer.encoder_apply_streaming(
        speech["semantic_encoder"], cfg.semantic_tokenizer,
        program_audio.float().to(x.device)[:, :, None], se)
    emb = (connectors.apply(speech["acoustic_connector"], R.scale_latents(lat))
           + connectors.apply(speech["semantic_connector"], sem[:, 0]))
    xs = [a for a, _ in head["steps"]]
    nexts = (R.solver_steps(speech["diffusion_head"], cfg, sv, cfg_scale, xs, *head["mods"])
             if len(xs) == sv.sched.num_steps else [])
    return {"hidden": h, "kv": new, "head_steps": [head["x_T"]] + nexts,
            "head_mods": R.modulations(speech["diffusion_head"], cfg, sv, head["cond"]),
            "decoder": chunk[:, :, 0],
            "semantic": RD.lm_slot0(p["lm"], dec, torch.cat([emb, emb]),
                                    [q + 1 for q in positions], wt)}


def numbers(cand_start, want_start, cand_end, want_end) -> Dict[str, float]:
    """Each compared number of a candidate (the program's observations or the
    float8 reference's outputs) against the reference's."""
    return {
        "start_kv_rel": max(check.rel_err(g[None], w[None])
                            for g, w in zip(cand_start["latent"], want_start["latent"])),
        "end_hidden_rel": check.rel_err(cand_end["hidden"], want_end["hidden"]),
        "end_kv_rel": check.rel_err(cand_end["kv"].transpose(0, 1),
                                    want_end["kv"].transpose(0, 1)),
        "end_head_step_rel": check._worst(cand_end["head_steps"], want_end["head_steps"]),
        "end_head_mods_rel": check._worst([m.flatten(0, -2) for m in cand_end["head_mods"]],
                                          [m.flatten(0, -2) for m in want_end["head_mods"]]),
        "end_decoder_rel": check.rel_err(cand_end["decoder"], want_end["decoder"]),
        "end_semantic_rel": check.rel_err(cand_end["semantic"], want_end["semantic"]),
        "end_moe_rel": check.rel_err(cand_end["moe"], want_end["moe"]),
        "end_routed_rel": check.rel_err(cand_end["routed"], want_end["routed"]),
    }


class ExpertTap:
    """Holds the program's own expert layers of one step: each layer's input
    to `deepseek_v2.moe`, its output, and the routed experts' weighed sum
    inside it (`deepseek_v2._experts_dense`), in the order of the layers.  As
    in `HeadTap`, the tensors of the captured step are kept, so after each
    replay they hold that replay's values, and no later call replaces them;
    without a capture, those of the newest step.  A call that routes token
    by token (a prompt) is not held.  Holding them adds no operation to the
    step."""

    def __init__(self):
        from vibevoice_tpu_torch.models import deepseek_v2
        self._mod = deepseek_v2
        self._real = {"moe": deepseek_v2.moe, "_experts_dense": deepseek_v2._experts_dense}
        deepseek_v2.moe, deepseek_v2._experts_dense = self._moe, self._dense
        self._routed = None
        self._keys: list = []
        self.seen: list = []
        self.frozen = False

    def _dense(self, *a, **k):
        self._routed = self._real["_experts_dense"](*a, **k)
        return self._routed

    def _moe(self, lp, cfg, h, tally=None):
        self._routed = None
        out = self._real["moe"](lp, cfg, h, tally)
        routed, self._routed = self._routed, None
        capturing = out.is_cuda and torch.cuda.is_current_stream_capturing()
        if routed is None or not (capturing or not self.frozen):
            return out
        if id(lp) in self._keys or capturing != self.frozen:  # a new step's first layer
            self._keys, self.seen = [], []
        self._keys.append(id(lp))
        self.seen.append((h, routed, out))
        self.frozen = capturing
        return out

    def read(self) -> dict:
        """The held layers, copied: inputs [N, H] each, and the routed sums
        and outputs [N, n_layers * H]; the tap lets go of the step's own
        tensors."""
        seen, self.seen, self._keys = self.seen, [], []
        n = seen[0][0].shape[-1]
        return {"h": [h.reshape(-1, n).clone() for h, _, _ in seen],
                "routed": torch.cat([y.reshape(-1, n) for _, y, _ in seen], dim=-1).clone(),
                "moe": torch.cat([o.reshape(-1, n) for _, _, o in seen], dim=-1).clone()}

    def close(self):
        self._mod.moe, self._mod._experts_dense = (self._real["moe"],
                                                   self._real["_experts_dense"])


def run(rn: Run) -> Outcome:
    # a program without the DeepSeek-V2 decoder cannot run this cell: stop at once
    from vibevoice_tpu_torch.models import deepseek_v2  # noqa: F401
    tap, experts = HeadTap(), ExpertTap()
    try:
        return _run(rn, tap, experts)
    finally:
        experts.close()
        tap.close()


def _run(rn: Run, tap: HeadTap, experts: ExpertTap) -> Outcome:
    from vibevoice_tpu_torch.configs import config_from_json
    from vibevoice_tpu_torch.engine import generate as G

    t0 = rn.hooks.get("t0", time.perf_counter())
    cell, tr, dev = rn.cell, rn.cell.traffic, rn.device
    cfg = RD.config_from_dict(cell.config_file)
    pcfg = config_from_json(os.path.join(ROOT, cell.config["file"]))
    ids = cell.config_file["token_ids"]
    dtype = DTYPES[cell.config_file["precision"]]
    b, hop = tr["batch"], cfg.speech_compress_ratio
    notes: List[str] = []

    # ---- set-up: weights, the first batch, the engine, its prefill and capture
    p = make_weights(cfg, traffic.sub_seed(rn.seed, "weights"), dev, dtype)
    params = rn.hooks["params"](p, pcfg) if "params" in rn.hooks else p
    batch0 = traffic.podcast_batch(tr, ids, cfg, rn.seed, 0, dev, dtype)
    engine = G.Engine(params, pcfg, generation_config(G, ids, tr), max_steps=tr["max_steps"],
                      batch=b, prompt_len=tr["prompt_len"], dtype=dtype,
                      inject_latent_noise=True, device=dev)

    state, out0 = engine.prefill(batch0.ids, batch0.attention_mask, batch0.speech_mask,
                                 batch0.speech_tensors, batch0.frame_masks,
                                 torch.Generator(device=dev).manual_seed(batch0.generator_seed),
                                 latent_noise=batch0.latent_noise)
    state, outs = engine.decode_chunk(state, 1)  # on the card: the capture
    sync(dev)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(traffic.sub_seed(rn.seed, "check rows"))
    start_rows = sorted(rng.choice(b, size=tr["check_rows"], replace=False).tolist())
    p_len = tr["prompt_len"]
    start_lat: list = []

    def read_start(st):
        if not start_lat:
            start_lat.extend(st.cache.latent[:, r, p_len - batch0.lengths[r]:p_len].clone()
                             for r in start_rows)

    # ---- the window
    spans = Spans(dev) if rn.trace else None
    proxy = LastStepProxy(engine, (state, G.StepOutput(*(x[0] for x in outs))), spans,
                          before_prefill=read_start)
    count = {"frames": 0, "skip": 1, "bad_rows": set()}

    def on_step(o):
        if count["skip"]:  # the prefill's output replayed from set-up
            count["skip"] -= 1
            return
        count["frames"] += int(o.emitted.sum())
        bad = o.emitted & ~np.isfinite(o.audio_chunk).all(axis=1)
        count["bad_rows"].update((count["batch"] * b + np.nonzero(bad)[0]).tolist())

    stopped: list = []

    def stop_check():
        if proxy.snap:  # the last chunk's outputs are on the host: the window closes
            stopped.append(time.perf_counter())
            return True
        if time.perf_counter() >= deadline:
            proxy.split = True  # the window's last chunk follows
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
        if proxy.snap:
            break
        index += 1
    window_s = stopped[0] - t_start
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    st, snap = proxy.state, proxy.snap

    # ---- what the check reads of the program, before anything else runs
    head = tap.read()
    moe_seen = experts.read()
    k, wp = snap["step"], snap["write_pos"]
    rows = list(range(b))
    read_start(st)
    seqs = rows + [b + r for r in rows]
    after = st.host_step - snap["host_step"]
    ctx = st.acoustic_state[0].buf
    if after != 1:
        raise RuntimeError(f"{after} steps ran after the window's snapshot, not 1")
    f_last = (st.frames.long() - 1).clamp(0, bt.latent_noise.shape[0] - 1)
    head["x_T"] = bt.latent_noise[f_last.to(bt.latent_noise.device),
                                  torch.arange(b, device=bt.latent_noise.device)]
    obs_start = {"latent": start_lat}
    obs_end = {"hidden": head["cond"], "kv": st.cache.latent[:, seqs, wp].clone(),
               "head_steps": [x for x, _ in head["steps"][:1]] + [y for _, y in head["steps"]],
               "head_mods": list(head["mods"][0]) + [head["mods"][1]],
               "decoder": st.audio[:, k].clone(),
               "routed": moe_seen["routed"], "moe": moe_seen["moe"]}
    latent = ctx[:, ctx.shape[1] - 1].clone()
    vis = [torch.nonzero(snap["visible"][j])[:, 0] for j in seqs]
    past = [st.cache.latent[:, j, vis[i]].clone() for i, j in enumerate(seqs)]
    # one step more (outside the window): it writes the next input's
    # first-layer slot, which the semantic number reads
    st, _ = engine.decode_chunk(st, 1)
    obs_end["semantic"] = st.cache.latent[0, seqs, wp + 1].clone()

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

    def reference(wt=None):
        with torch.no_grad():
            lm = p["lm"] if wt is None else dict(p["lm"], embed=wt(p["lm"]["embed"]))
            pw = dict(p, lm=lm)
            embeds = prompt_rows(pw if wt is None else dict(
                pw, acoustic_encoder=wt(p["acoustic_encoder"]),
                acoustic_connector=wt(p["acoustic_connector"])), cfg, batch0,
                tr["speakers"], start_rows, dtype)
            _, lat = RD.lm_prompt(lm, cfg.decoder, embeds, wt)
            e = end_outputs(pw, cfg, sv, tr["cfg_scale"], snap, rows,
                            lambda li, j: past[j][li], latent, obs_end["decoder"], head, wt)
            e["routed"], e["moe"] = RD.expert_layers(lm, cfg.decoder, moe_seen["h"], wt)
        return {"latent": lat}, e

    want_start, want_end = reference()
    compared = numbers(obs_start, want_start, obs_end, want_end)
    fp8_reference = {}
    if rn.hooks.get("fp8_reference"):  # the reference with float8 weights in the program's place
        fs, fe = reference(check.fp8_weights)
        fp8_reference = numbers(fs, want_start, fe, want_end)
    attempted = b * (index + 1)
    return Outcome(
        end_to_end={"audio_s_per_s": count["frames"] * hop / traffic.SAMPLE_RATE / window_s,
                    "setup_s": setup_s},
        per_layer=per_layer, attempted=attempted, failed=len(count["bad_rows"]),
        compared=compared, fp8_reference=fp8_reference, memory_peak_bytes=peak, busy_s=busy_s,
        window_s=window_s, breakdown=breakdown,
        notes=[f"window {window_s:.4f} s, {count['frames']} frames emitted, {index + 1} "
               f"batch(es), compared step {k} at slot {wp}; set-up {setup_s:.4f} s"] + notes)


__all__ = ["run", "make_weights", "LastStepProxy", "ExpertTap", "prompt_rows", "end_outputs", "numbers"]
