"""What decides `correct`: the program's served audio, the latent its decoder
took, and what its steps wrote into the cache, against the plain reference
(`reference/model.py`), each as a relative error whose limit is in
`limits/<workload>.json`.

From the inputs alone (the prefill, as set-up ran it for the first batch):
  start_audio0_rel  the prefill's frame: voice prompts through the acoustic
                    encoder and connector, the prompt through the LM (flash
                    prefill from 1024 tokens), the CFG head through the
                    solver, the sigma-VAE decoder's chunk;
  start_kv_rel      the k and v the prefill wrote for the prompt, every layer.
From the program's own state as the window left it (its cache, visibility,
positions and streaming states), the first step of the window's last chunk:
  end_latent_rel    LM decode over the live cache and the CFG head through
                    the solver: the latent, read back from the decoder's
                    first conv, which keeps its last inputs;
  end_head_step_rel the CFG head and the solver, step by step, teacher-forced
                    on the program's own samples of the window's last step
                    (the driver's tap): from x_T, each solver step's next
                    sample from the program's sample before it and its
                    per-step modulations (the head's adaLN matrices), the
                    last step's against the latent the head returned;
  end_head_mods_rel those modulations against the reference's, from the
                    program's own hidden states (printed, not compared:
                    PERF.md, Open questions);
  end_audio_rel     that step's audio chunk;
  end_kv_rel        the k and v that step wrote into the cache, every layer;
  end_decoder_rel   the sigma-VAE decoder alone: the chunk from the
                    program's own latent;
  end_semantic_rel  the semantic re-encode and connectors alone: the first
                    layer's k and v of the next input, which the following
                    step wrote into the cache, from the program's own chunk
                    and latent.

A random model grows a difference about 5x a fed-back frame, so the
reference never free-runs past one frame: the start is computed from the
inputs, the end from the program's state (PERF.md).  Each number is the
worst row's ||candidate - reference|| / ||reference||; a value that is not
finite reads inf.  The candidate is the program's observed output, or the
reference itself with its weights in float8 (`fp8_weights`), which sets the
upper readings of the limits (PERF.md says why it stands in for the
program's own int8 path, which separates on no number).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .reference import connectors, tokenizer
from .reference import model as R


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's relative L2 error of `got` [N, ...] against `want`."""
    got, want = got.float().to(want.device), want.float()
    if got.shape != want.shape or not (torch.isfinite(got).all()
                                       and torch.isfinite(want).all()):
        return math.inf
    num = (got - want).flatten(1).norm(dim=1)
    den = want.flatten(1).norm(dim=1).clamp_min(1e-30)
    return float((num / den).max())


def fp8_weights(tree):
    """Every weight matrix and conv kernel rounded to float8 e4m3 with one
    scale per output channel (the last axis); vectors and scalars as they
    are: a precision below the configuration's bf16."""
    if isinstance(tree, dict):
        return {k: fp8_weights(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_weights(v) for v in tree]
    if not torch.is_tensor(tree) or tree.dim() < 2:
        return tree
    w = tree.float()
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True).clamp_min(1e-30)
    scale = amax / torch.finfo(torch.float8_e4m3fn).max
    return ((w / scale).to(torch.float8_e4m3fn).float() * scale).to(tree.dtype)


def start_outputs(p, cfg, sv: R.Solver, cfg_scale: float, ids: Dict, batch, speakers: int,
                  rows: Sequence[int], n_frames: int, draw_dtype) -> Dict:
    """The first `n_frames` frames' audio [n, hop] of `rows` and each row's
    prompt k and v [L, T_r, nkv*hd], from the batch's inputs alone."""
    dev = batch.latent_noise.device
    n_voices = batch.speech_tensors.shape[0]
    frames = batch.frame_masks.shape[1]
    gen = torch.Generator(device=dev).manual_seed(batch.generator_seed)
    # the voice sampling noise of the whole batch, drawn as the prefill draws it
    std = torch.randn(n_voices, generator=gen, dtype=draw_dtype, device=dev).float()
    eps = torch.randn((n_voices, frames, cfg.acoustic_vae_dim), generator=gen,
                      dtype=draw_dtype, device=dev).float()
    fix = cfg.acoustic_tokenizer.fix_std / 0.8
    enc = R.to_f32(p["acoustic_encoder"])
    prompts = []
    for r in rows:
        vidx = list(range(r * speakers, (r + 1) * speakers))
        mean = torch.cat([tokenizer.encoder_apply(enc, cfg.acoustic_tokenizer,
                                                  batch.speech_tensors[i][None, :, None].float())
                          for i in vidx])
        lat = mean + (std[vidx] * fix)[:, None, None] * eps[vidx]
        real = torch.as_tensor(batch.attention_mask[r] == 1)
        prompts.append(R.Prompt(
            ids=torch.as_tensor(batch.ids[r])[real].to(dev),
            speech_mask=torch.as_tensor(batch.speech_mask[r])[real].to(dev),
            voice_frames=R.scale_latents(lat).reshape(-1, cfg.acoustic_vae_dim)))
    del enc
    x_init = batch.latent_noise[:n_frames, list(rows)]
    audio, (kp, vp) = R.first_frames(p, cfg, sv, cfg_scale, prompts, ids["speech_start"],
                                     x_init, n_frames)
    return {"audio": audio, "prompt_k": kp, "prompt_v": vp}


def end_outputs(p, cfg, sv: R.Solver, cfg_scale: float, snap: Dict, rows: Sequence[int],
                past, latent_noise: torch.Tensor, program_latent: torch.Tensor,
                program_audio: torch.Tensor, head: Dict) -> Dict:
    """One step of `rows` from the program's state `snap`.  `past(layer, j)`
    gives sequence j's visible cache entries (j < n: row rows[j]'s positive
    stream, j >= n: its negative stream).  Besides the step's own latent
    (unscaled, as the decoder takes it), audio and k, v [L, 2n, nkv*hd], the
    decoder's chunk from `program_latent` [n, latent] and the next input's
    first-layer k, v from `program_audio` [n, hop] and that latent, and the
    head's steps and modulations from `head`, the program's own of one step
    (`head_observations`)."""
    dec = cfg.decoder
    rows = list(rows)
    n = len(rows)
    x = snap["cur_embeds"][rows].float()
    positions = ([int(snap["pos_positions"][r]) for r in rows]
                 + [int(snap["neg_positions"][r]) for r in rows])
    h, nk, nv = R.lm_step(p["lm"], dec, torch.cat([x, x]), positions, past)
    f_idx = snap["frames"][rows].long().clamp(max=latent_noise.shape[0] - 1)
    x_init = latent_noise[f_idx.to(latent_noise.device), torch.as_tensor(rows)]
    p32 = R.speech_params_f32(p)
    ac = R.states_rows(snap["acoustic_state"], rows)
    se = R.states_rows(snap["semantic_state"], rows)
    fr = R.speech_frame(p32, cfg, sv, cfg_scale, h[:n], h[n:], x_init, ac, se)
    nxt = [q + 1 for q in positions]
    # the stages alone, from the program's own latent and chunk
    lat = program_latent.float().to(x.device)
    chunk, _ = tokenizer.decoder_apply_streaming(p32["acoustic_decoder"],
                                                 cfg.acoustic_tokenizer, lat[:, None], ac)
    sem, _ = tokenizer.encoder_apply_streaming(
        p32["semantic_encoder"], cfg.semantic_tokenizer,
        program_audio.float().to(x.device)[:, :, None], se)
    emb = (connectors.apply(p32["acoustic_connector"], R.scale_latents(lat))
           + connectors.apply(p32["semantic_connector"], sem[:, 0]))
    xs = [a for a, _ in head["steps"]]
    nexts = (R.solver_steps(p32["diffusion_head"], cfg, sv, cfg_scale, xs, *head["mods"])
             if len(xs) == sv.sched.num_steps else [])
    return {"latent": R.unscale_latents(fr.latent), "audio": fr.audio, "kv": (nk, nv),
            "head_steps": [head["x_T"]] + nexts,
            "head_mods": R.modulations(p32["diffusion_head"], cfg, sv, head["cond"]),
            "decoder": chunk[:, :, 0],
            "semantic": R.lm_kv0(p["lm"], dec, torch.cat([emb, emb]), nxt)}


def _worst(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """The worst of `rel_err` over two lists of rows [R, D], inf where the
    lists differ in length."""
    if len(got) != len(want):
        return math.inf
    return max(rel_err(g, w) for g, w in zip(got, want))


def _kv_err(got, want) -> float:
    """Worst sequence over k and v given [L, N, F] each."""
    return max(rel_err(got[0].transpose(0, 1), want[0].transpose(0, 1)),
               rel_err(got[1].transpose(0, 1), want[1].transpose(0, 1)))


def numbers(cand_start: Dict, want_start: Dict, cand_end: Dict,
            want_end: Dict) -> Dict[str, float]:
    """Each compared number of a candidate (the program's observations, or
    the float8-weight reference's outputs) against the reference's."""
    return {
        "start_audio0_rel": rel_err(cand_start["audio"][0], want_start["audio"][0]),
        "start_kv_rel": max(max(rel_err(gk[None], wk[None]), rel_err(gv[None], wv[None]))
                            for gk, gv, wk, wv in zip(cand_start["prompt_k"],
                                                      cand_start["prompt_v"],
                                                      want_start["prompt_k"],
                                                      want_start["prompt_v"])),
        "end_latent_rel": rel_err(cand_end["latent"], want_end["latent"]),
        "end_head_step_rel": _worst(cand_end["head_steps"], want_end["head_steps"]),
        "end_head_mods_rel": _worst([m.flatten(0, -2) for m in cand_end["head_mods"]],
                                    [m.flatten(0, -2) for m in want_end["head_mods"]]),
        "end_audio_rel": rel_err(cand_end["audio"], want_end["audio"]),
        "end_kv_rel": _kv_err(cand_end["kv"], want_end["kv"]),
        "end_decoder_rel": rel_err(cand_end["decoder"], want_end["decoder"]),
        "end_semantic_rel": max(rel_err(cand_end["semantic"][0], want_end["semantic"][0]),
                                rel_err(cand_end["semantic"][1], want_end["semantic"][1])),
    }


def head_observations(seen: Dict) -> Dict:
    """The program's CFG sampling of one step as the reference takes it, from
    the driver's tap: the two streams' hidden states, each solver step's
    (sample in, sample out) with the last step's out replaced by the latent
    the head returned, and the modulations (layer_mods, final_mod)."""
    steps = list(seen["steps"])
    if steps:
        steps[-1] = (steps[-1][0], seen["latent"])
    return {"cond": torch.cat([seen["cond"], seen["neg"]]), "steps": steps,
            "mods": (seen["mods"][0], seen["mods"][1])}


def program_observations(first_frames: List[torch.Tensor], prompt_kv, latent, audio, kv,
                         kv_next, head: Dict) -> tuple:
    """The program's outputs in the shape `numbers` takes: its first frame
    and prompt cache (start), and its step's latent, audio, cache writes and
    the next step's first-layer writes, and its head's samples and
    modulations at the tapped step (end; the decoder and semantic numbers
    read the same observed audio and writes)."""
    start = {"audio": first_frames, "prompt_k": [k for k, _ in prompt_kv],
             "prompt_v": [v for _, v in prompt_kv]}
    end = {"latent": latent, "audio": audio, "kv": kv,
           "head_steps": [x for x, _ in head["steps"][:1]] + [y for _, y in head["steps"]],
           "head_mods": list(head["mods"][0]) + [head["mods"][1]],
           "decoder": audio, "semantic": kv_next}
    return start, end


__all__ = ["rel_err", "fp8_weights", "start_outputs", "end_outputs", "numbers",
           "head_observations", "program_observations"]
