"""File-to-podcast CLI on the port: voice-preset mapping, txt script parsing,
generation, RTF metrics, wav output.

The port of `demo/inference_from_file.py` (the reference's canonical entry
point, `demo/inference_from_file.py:182-400`), on the card unless
`--device cpu` is given:

  python -m vibevoice_tpu_torch.demo.inference_from_file \\
      --txt_path demo/text_examples/2p_dialogue.txt --model_path /path/to/VibeVoice-1.5B
  python -m vibevoice_tpu_torch.demo.inference_from_file \\
      --txt_path demo/text_examples/1p_short.txt --tiny --device cpu

`--tiny` builds a tiny random model (`tiny_config(vocab_size=320)`, fp32);
without `--model_path` or `--tiny` the weights are a random 1.5B.  Voice
presets come from the repo's `demo/voices` unless `--voices_dir` says
otherwise.  `VoiceMapper`, `parse_txt_script`, `model_args` and `load_tts`
serve the port's other CLIs too.
"""
from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VOICES_DIR = os.path.join(REPO_ROOT, "demo", "voices")


class VoiceMapper:
    """Map speaker names -> voice preset files (ref :17-90), scanned from
    `voices_dir` (default: the repo's `demo/voices`), then `extra_dirs`."""

    def __init__(self, voices_dir: str | None = None, extra_dirs: tuple = ()):
        self.voices_dir = voices_dir or VOICES_DIR
        self.voice_presets = {}
        for d in (self.voices_dir, *extra_dirs):
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.endswith((".wav", ".mp3", ".flac", ".npy")):
                    name = os.path.splitext(f)[0].split("_")[0]
                    self.voice_presets.setdefault(name, os.path.join(d, f))

    def get_voice_path(self, speaker_name: str) -> str | None:
        if not self.voice_presets:
            return None
        for name, path in self.voice_presets.items():
            if speaker_name.lower() in name.lower() or name.lower() in speaker_name.lower():
                return path
        return next(iter(self.voice_presets.values()))


def parse_txt_script(txt: str):
    """'Speaker N: text' lines -> (script, speaker names) (ref :93-136)."""
    lines = [l.strip() for l in txt.split("\n") if l.strip()]
    speakers, out_lines = [], []
    for line in lines:
        m = re.match(r"^Speaker\s+(\w+)\s*:\s*(.*)$", line, re.IGNORECASE)
        if m:
            sp = m.group(1)
            if sp not in speakers:
                speakers.append(sp)
            out_lines.append(f"Speaker {speakers.index(sp) + 1}: {m.group(2)}")
        else:
            out_lines.append(f"Speaker 1: {line}")
            if "1" not in speakers:
                speakers.append("1")
    return "\n".join(out_lines), speakers


def neutral_voice() -> np.ndarray:
    """1 s of low-level noise: the voice prompt of a speaker with no preset."""
    return np.random.default_rng(0).normal(0, 0.02, 24000).astype(np.float32)


def model_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The model and device flags every generating CLI of the port takes."""
    ap.add_argument("--model_path", type=str, default=None,
                    help="HF-format VibeVoice checkpoint dir (random weights if omitted)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random fp32 model (smoke test, noise output)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--voices_dir", type=str, default=None,
                    help="voice presets (default: the repo's demo/voices)")
    ap.add_argument("--cfg_scale", type=float, default=1.3)
    ap.add_argument("--ddpm_steps", type=int, default=10)
    ap.add_argument("--max_new_tokens", type=int, default=512)
    return ap


def load_tts(args, device):
    """`VibeVoiceTTS` from `--model_path`, else the tiny random model with
    `--tiny` (at most 4 solver steps), else a random 1.5B."""
    import torch
    from ..pipeline import VibeVoiceTTS

    if args.model_path:
        return VibeVoiceTTS.from_pretrained(args.model_path, cfg_scale=args.cfg_scale,
                                            ddpm_steps=args.ddpm_steps, device=device)
    if args.tiny:
        from ..configs import tiny_config
        print("WARNING: tiny random model (smoke run, output is noise)")
        return VibeVoiceTTS.from_random(cfg=tiny_config(vocab_size=320), dtype=torch.float32,
                                        cfg_scale=args.cfg_scale,
                                        ddpm_steps=min(args.ddpm_steps, 4), device=device)
    print("WARNING: no --model_path; using random weights (smoke run)")
    return VibeVoiceTTS.from_random(cfg_scale=args.cfg_scale, ddpm_steps=args.ddpm_steps,
                                    device=device)


def main(argv=None):
    ap = model_args(argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.demo.inference_from_file"))
    ap.add_argument("--txt_path", type=str, required=True)
    ap.add_argument("--speaker_names", type=str, nargs="*", default=None)
    ap.add_argument("--output_dir", type=str, default="./outputs")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)

    with open(args.txt_path, encoding="utf-8") as f:
        txt = f.read()
    script, speakers = parse_txt_script(txt)

    mapper = VoiceMapper(args.voices_dir)
    names = args.speaker_names or speakers
    voices = [mapper.get_voice_path(name) or neutral_voice() for name in names]

    t0 = time.time()
    tts = load_tts(args, device)
    print(f"model ready in {time.time()-t0:.1f}s")

    res, metrics = tts.generate(script, voices, max_new_tokens=args.max_new_tokens,
                                seed=args.seed, show_progress=True)

    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.txt_path))[0]
    out_path = os.path.join(args.output_dir, f"{base}_generated.wav")
    if res.audio[0] is not None:
        tts.save_audio(res.audio[0], out_path)
        print(f"saved {out_path} ({len(res.audio[0])/24000:.1f}s audio)")
    else:
        out_path = None
        print("no audio frames generated")
    print(f"steps={metrics['steps']} wall={metrics['wall_s']:.2f}s "
          f"audio={metrics['audio_sec']:.2f}s RTF={metrics['rtf']:.3f}")
    return {"wav": out_path, "metrics": metrics}


if __name__ == "__main__":
    main()
