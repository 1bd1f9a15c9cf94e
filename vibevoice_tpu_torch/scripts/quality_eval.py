"""Quality-evaluation harness on the port (weights-gated).

The port of `scripts/quality_eval.py`.  Given an HF VibeVoice checkpoint,
loads the weights, generates the demo scripts, and reports mel/log-spectral
distances and SNR between the bf16 baseline and candidate configurations
(int8 / int4 / int4f / kv_dtype=int8 / 5-step SDE / the σ-VAE and head
kernels).  Without `--model_path` it runs the full plumbing on a tiny random
model, the diffusion branch forced, so the harness itself stays verified.
It runs on the card unless `--device cpu` is given:

  python -m vibevoice_tpu_torch.scripts.quality_eval \\
      --model_path /path/to/VibeVoice-1.5B --voices_dir demo/voices \\
      --scripts demo/text_examples/2p_dialogue.txt --canonical
  python -m vibevoice_tpu_torch.scripts.quality_eval --device cpu  # tiny plumbing run

The run emits a pass/fail verdict per candidate against explicit
mel-L2/LSD/SNR thresholds (see THRESHOLDS) and recommends the serving-mode
table (B=1 / B>=2 / tokenizer ladders ordered by measured speed) with no
judgment calls (`decide()`).
"""
import argparse
import json
import os
import tempfile

import numpy as np


def _load_voice(path, sr=24000):
    from ..processor.audio import load_audio
    return load_audio(path, sampling_rate=sr)


# fixed seeds of the tiny model's weights: the same model in every process
TINY_SEED = 0
TINY_HEAD_SEED = 9


def _build_tts(args, quantize=None, kv_dtype="model", algorithm_type="dpmsolver++",
               ddpm_steps=None, quantize_tokenizer=None, int4_group_size=None,
               use_fused_stages=False, quantize_diffusion=None):
    import torch
    from ..pipeline import VibeVoiceTTS

    kw = dict(dtype=torch.bfloat16 if args.model_path else torch.float32,
              ddpm_steps=ddpm_steps or args.ddpm_steps,
              cfg_scale=args.cfg_scale,
              quantize=quantize, kv_dtype=kv_dtype, algorithm_type=algorithm_type,
              quantize_tokenizer=quantize_tokenizer,
              quantize_diffusion=quantize_diffusion,
              use_fused_stages=use_fused_stages,
              # tiny-config stacks have dims << 512; quantize them anyway so
              # the random-weight plumbing check exercises the quantized path
              tokenizer_min_dim=512 if args.model_path else 1,
              int4_group_size=int4_group_size, device=args.device)
    if args.model_path:
        return VibeVoiceTTS.from_pretrained(args.model_path, **kw)
    from ..configs import tiny_config
    from ..models import vibevoice as V
    from ..processor.text_tokenizer import ByteFallbackTokenizer
    dev = torch.device(args.device)
    cfg = tiny_config(vocab_size=320)
    params = V.init_model(cfg, dtype=kw["dtype"], device=dev,
                          generator=torch.Generator(device=dev).manual_seed(TINY_SEED))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    # the head's adaLN/final layers are zero-init (reference behavior); with
    # them zero the sampled latent is weight-independent and every quantized
    # config would compare bit-identical — randomize so the A/B is real
    gen = torch.Generator(device=dev).manual_seed(TINY_HEAD_SEED)
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen, device=dev,
                                  dtype=kw["dtype"]) * 0.05
    for name in ("final_ada_w", "final_linear"):
        head[name] = torch.randn(head[name].shape, generator=gen, device=dev,
                                 dtype=kw["dtype"]) * 0.05
    return VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), **kw)


CANDIDATES = {
    "int8": dict(quantize="int8"),
    "int4": dict(quantize="int4"),
    "int4-g128": dict(quantize="int4", int4_group_size="auto128"),
    "int4-g64": dict(quantize="int4", int4_group_size="auto64"),
    "int8kv": dict(quantize="int8", kv_dtype="int8"),
    "sde5": dict(algorithm_type="sde-dpmsolver++", ddpm_steps=5),
    # σ-VAE stack quantization (vocoder + semantic re-encode FFNs)
    "tok8": dict(quantize_tokenizer="int8"),
    "tok4": dict(quantize_tokenizer="int4"),
    "int4+tok8": dict(quantize="int4", quantize_tokenizer="int8"),
    "int4+tok4": dict(quantize="int4", quantize_tokenizer="int4"),
    # the r3 serving recommendations
    "int4f": dict(quantize="int4f"),
    "int4f-g128": dict(quantize="int4f", int4_group_size="auto128"),
    "int4k": dict(quantize_tokenizer="int4k"),
    "int4f+int4k": dict(quantize="int4f", quantize_tokenizer="int4k"),
    "int4f-g128+int4k": dict(quantize="int4f", int4_group_size="auto128",
                             quantize_tokenizer="int4k"),
    "int8+int4k": dict(quantize="int8", quantize_tokenizer="int4k"),
    # engine-kernel numerics variants (no quantization): the fused large-T
    # stage kernel (+ folded transition convs) runs fp32 inside the kernel;
    # recommended serving configs enable it, so the weights-day run
    # certifies it too
    "fs": dict(use_fused_stages=True),
    # the middle mode: token-exact bf16 LM, quantized σ-VAE
    "int4k+fs": dict(quantize_tokenizer="int4k", use_fused_stages=True),
    "int8+int4k+fs": dict(quantize="int8", quantize_tokenizer="int4k",
                          use_fused_stages=True),
    "int4f+int4k+fs": dict(quantize="int4f", quantize_tokenizer="int4k",
                           use_fused_stages=True),
    # fused int4 diffusion-head solver kernel (ops/fused_head.py): the head
    # produces the output latent, so its int4 quantization is the most
    # quality-sensitive candidate — certify separately and composed
    "dh4": dict(quantize_diffusion="int4k"),
    "int8+int4k+fs+dh4": dict(quantize="int8", quantize_tokenizer="int4k",
                              use_fused_stages=True,
                              quantize_diffusion="int4k"),
    "int4f+int4k+fs+dh4": dict(quantize="int4f", quantize_tokenizer="int4k",
                               use_fused_stages=True,
                               quantize_diffusion="int4k"),
}

# ---------------------------------------------------------------------------
# Pass/fail decision rule: one command on weights day, no judgment calls.
#
# Thresholds (vs the bf16 exact baseline, same seed — quantization noise
# only, not absolute quality):
#   * mel_l2  <= 1.0  — mean per-frame L2 over 80 log-mel bins; 1.0 ≈ 1 dB
#     average mel-band deviation (0.115 nat/bin * sqrt(80)), the classic
#     transparency bar.
#   * lsd_db  <= 1.0  — log-spectral distance; <1 dB is the codec-literature
#     threshold for "perceptually transparent" spectral distortion.
#   * snr_db  >= 20   — quantization error >=20 dB below signal.
#
# The ladders are the JAX harness's, ordered by the speed measured there;
# the first candidate that passes all thresholds on every script wins.
# Candidates not measured in this run are skipped (run the canonical full
# set below to make the recommendation binding).
# ---------------------------------------------------------------------------

THRESHOLDS = {"mel_l2_max": 1.0, "lsd_max_db": 1.0, "snr_min_db": 20.0}

# best-performance-first ladders; "bf16" = exact numerics, always passes
LADDER_B1 = ["int4f+int4k+fs+dh4", "int4f+int4k+fs", "int4f+int4k",
             "int4f-g128+int4k", "int4f",
             "int4f-g128", "int8+int4k", "int8", "bf16"]
LADDER_BATCH = ["int4f+int4k+fs+dh4", "int4f+int4k+fs",
                "int8+int4k+fs+dh4", "int8+int4k+fs", "int8+int4k", "int8",
                "bf16"]
LADDER_TOKENIZER = ["int4k+fs", "int4k", "tok8", "bf16"]  # σ-VAE quant alone

# the weights-day one-command candidate set
CANONICAL_CANDIDATES = ["int4f+int4k", "int4f-g128+int4k", "int4f",
                        "int4f-g128", "int8+int4k", "int8", "int4k", "tok8",
                        "fs", "int4k+fs", "int8+int4k+fs", "int4f+int4k+fs",
                        "dh4", "int8+int4k+fs+dh4", "int4f+int4k+fs+dh4"]


def decide(measured, thresholds=None):
    """measured: {candidate: [per-script metric dicts with mel_l2/lsd_db/snr_db]}.

    Returns {"thresholds", "verdicts": {cand: {"pass", "fails"}},
    "recommended": {"B1", "B>=2", "tokenizer"}} — the serving-mode table
    implied by the quality run (see module comment for the rule).
    """
    th = dict(THRESHOLDS)
    th.update(thresholds or {})
    verdicts = {}
    for cand, metric_list in measured.items():
        fails = []
        for i, m in enumerate(metric_list):
            def _f(v):
                return float("inf") if v in ("inf", None) else float(v)
            if _f(m["mel_l2"]) > th["mel_l2_max"]:
                fails.append(f"script{i}: mel_l2 {m['mel_l2']} > {th['mel_l2_max']}")
            if _f(m["lsd_db"]) > th["lsd_max_db"]:
                fails.append(f"script{i}: lsd_db {m['lsd_db']} > {th['lsd_max_db']}")
            snr = m["snr_db"]
            snr = float("inf") if snr == "inf" else float(snr)
            if snr < th["snr_min_db"]:
                fails.append(f"script{i}: snr_db {m['snr_db']} < {th['snr_min_db']}")
        verdicts[cand] = {"pass": not fails, "fails": fails}

    def pick(ladder):
        for c in ladder:
            if c == "bf16":
                return "bf16 (exact numerics)"
            v = verdicts.get(c)
            if v is None:
                continue  # not measured this run
            if v["pass"]:
                return c
        return "bf16 (exact numerics)"

    return {
        "thresholds": th,
        "verdicts": verdicts,
        "recommended": {"B1": pick(LADDER_B1), "B>=2": pick(LADDER_BATCH),
                        "tokenizer": pick(LADDER_TOKENIZER)},
    }


def main(argv=None):
    from ..demo.inference_from_file import VOICES_DIR

    ap = argparse.ArgumentParser(prog="python -m vibevoice_tpu_torch.scripts.quality_eval")
    ap.add_argument("--model_path", default=None,
                    help="HF checkpoint dir; omitted = tiny random plumbing check")
    ap.add_argument("--scripts", nargs="*", default=None, help="script .txt paths")
    ap.add_argument("--voices_dir", default=VOICES_DIR)
    ap.add_argument("--candidates", nargs="*", default=["int8", "int4"],
                    choices=sorted(CANDIDATES), help="configs to compare vs baseline")
    ap.add_argument("--canonical", action="store_true",
                    help="run the weights-day canonical candidate set and emit "
                         "the binding mode recommendation")
    ap.add_argument("--mel_l2_max", type=float, default=THRESHOLDS["mel_l2_max"])
    ap.add_argument("--lsd_max_db", type=float, default=THRESHOLDS["lsd_max_db"])
    ap.add_argument("--snr_min_db", type=float, default=THRESHOLDS["snr_min_db"])
    ap.add_argument("--ddpm_steps", type=int, default=10)
    ap.add_argument("--cfg_scale", type=float, default=1.3)
    ap.add_argument("--max_new_tokens", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output_dir", default=os.path.join(tempfile.gettempdir(),
                                                         "quality_eval"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..utils import audio_metrics as AM
    args.device = resolve_device(args.device)

    os.makedirs(args.output_dir, exist_ok=True)

    # ---- inputs -----------------------------------------------------------
    if args.scripts:
        scripts = []
        for p in args.scripts:
            with open(p, encoding="utf-8") as f:
                scripts.append(f.read())
        names = [os.path.splitext(os.path.basename(p))[0] for p in args.scripts]
    else:
        scripts = ["Speaker 1: The quick brown fox jumps over the lazy dog.\n"
                   "Speaker 2: And then it ran away into the forest."]
        names = ["builtin_smoke"]

    voices = []
    if args.model_path and os.path.isdir(args.voices_dir):
        wavs = sorted(f for f in os.listdir(args.voices_dir) if f.endswith(".wav"))
        voices = [_load_voice(os.path.join(args.voices_dir, w)) for w in wavs[:4]]
    if not voices:  # random-weight mode: tiny synthetic voice prompts (the
        # tiny config's hop is small, so long voices would explode the prompt)
        rng = np.random.default_rng(0)
        voices = [rng.normal(0, 0.05, 64).astype(np.float32)]

    max_new = args.max_new_tokens or (None if args.model_path else 8)

    def gen(tts, script):
        if not args.model_path:
            # random weights never argmax the diffusion token; force it so the
            # full latent->vocoder path runs
            from ..engine import generate as G
            gcfg = G.GenerationConfig(
                speech_start_id=tts.tokenizer.speech_start_id,
                speech_end_id=tts.tokenizer.speech_end_id,
                speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
                eos_id=tts.tokenizer.eos_id, ddpm_steps=tts.ddpm_steps,
                cfg_scale=tts.cfg_scale, algorithm_type=tts.algorithm_type,
                force_diffusion=True)
            eng = G.Engine(tts.params, tts.cfg, gcfg, max_steps=max_new, batch=1,
                           prompt_len=512, dtype=tts.dtype, kv_dtype=tts.kv_dtype,
                           use_fused_stages=tts.use_fused_stages,
                           fused_stage_t_min=7 if tts.use_fused_stages
                           and tts.cfg.decoder.hidden_size < 256 else 128,
                           device=tts.device)
            tts._engine = lambda b, p, m: eng
        res, metrics = tts.generate(script, voices[:1], max_new_tokens=max_new,
                                    seed=args.seed)
        return res.audio[0], metrics

    # ---- baseline ---------------------------------------------------------
    base = _build_tts(args)
    results = {}
    base_audio = {}
    for name, script in zip(names, scripts):
        audio, metrics = gen(base, script)
        assert audio is not None, f"baseline produced no audio for {name}"
        base_audio[name] = audio
        results[f"baseline/{name}"] = {"rtf": round(metrics["rtf"], 2),
                                       "audio_sec": round(metrics["audio_sec"], 2)}
        base.save_audio(audio, os.path.join(args.output_dir, f"baseline_{name}.wav"))
    del base

    # ---- candidates -------------------------------------------------------
    candidates = CANONICAL_CANDIDATES if args.canonical else args.candidates
    measured = {}
    for cand in candidates:
        kw = dict(CANDIDATES[cand])
        ddpm = kw.pop("ddpm_steps", None)
        gs = kw.pop("int4_group_size", None)
        if gs == "auto128":
            gs = 128 if args.model_path else 32  # tiny hidden dims are small
        elif gs == "auto64":
            gs = 64 if args.model_path else 16
        tts = _build_tts(args, ddpm_steps=ddpm, int4_group_size=gs, **kw)
        for name, script in zip(names, scripts):
            audio, metrics = gen(tts, script)
            assert audio is not None, f"{cand} produced no audio for {name}"
            m = AM.compare(base_audio[name], audio)
            m["rtf"] = round(metrics["rtf"], 2)
            results[f"{cand}/{name}"] = {k: (round(v, 4) if np.isfinite(v) else "inf")
                                         for k, v in m.items()}
            measured.setdefault(cand, []).append(results[f"{cand}/{name}"])
            tts.save_audio(audio, os.path.join(args.output_dir, f"{cand}_{name}.wav"))
        del tts

    # ---- pass/fail verdict + serving-mode recommendation ------------------
    # (sde5 is a solver-config candidate, not a quantization mode: its delta
    # vs the baseline is the step-count change itself, so it is excluded
    # from the quantization pass/fail rule)
    verdict = decide({c: ms for c, ms in measured.items() if c != "sde5"},
                     {"mel_l2_max": args.mel_l2_max, "lsd_max_db": args.lsd_max_db,
                      "snr_min_db": args.snr_min_db})
    results["verdict"] = verdict
    if not args.model_path:
        results["verdict"]["note"] = (
            "random-weight plumbing dry-run — NOT a quality statement; rerun "
            "with --model_path and --canonical on a real checkpoint")

    print(json.dumps(results, indent=2))
    with open(os.path.join(args.output_dir, "quality_eval.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
