"""Post-hoc captioning for existing audio: given a wav and its script, emit the
caption package without generating audio again.

The port of the root `generate_captions_for_existing_audio.py` (the
reference's `generate_captions_for_existing_audio.py:18-151`).  It generates
no audio; with `--use_whisper` the STT model runs on the card unless
`--device cpu` is given:

  python -m vibevoice_tpu_torch.demo.generate_captions_for_existing_audio \\
      --audio_path outputs/2p_dialogue.wav --txt_path demo/text_examples/2p_dialogue.txt
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.demo.generate_captions_for_existing_audio")
    ap.add_argument("--audio_path", type=str, required=True)
    ap.add_argument("--txt_path", type=str, required=True)
    ap.add_argument("--output_dir", type=str, default=None)
    ap.add_argument("--use_whisper", action="store_true")
    ap.add_argument("--whisper_model", type=str, default="base")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the whisper model's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..caption.simple import SimpleCaptionFormatter, SimpleCaptionGenerator
    from ..device import resolve_device
    from ..processor.audio import load_audio
    from ..processor.processor import VibeVoiceProcessor
    from ..processor.text_tokenizer import ByteFallbackTokenizer
    device = resolve_device(args.device)

    wav = load_audio(args.audio_path)
    duration = len(wav) / 24000.0

    proc = VibeVoiceProcessor(ByteFallbackTokenizer())
    if args.txt_path.endswith(".txt"):
        script = proc._convert_text_to_script(args.txt_path)
    else:
        with open(args.txt_path, encoding="utf-8") as f:
            script = f.read()
    parsed = proc._parse_script(script)
    lines = [(f"Speaker {sid + 1}", text.strip()) for sid, text in parsed]

    segments = None
    if args.use_whisper:
        try:
            from ..caption.whisper import CaptionGenerator
            stt = CaptionGenerator(args.whisper_model, device=device.type)
            segments = stt.match_speakers(stt.transcribe(args.audio_path), lines)
        except ImportError as e:
            print(f"whisper unavailable ({e}); falling back to script timing")
    if segments is None:
        segments = SimpleCaptionGenerator().generate(lines, duration, args.audio_path)

    out_dir = args.output_dir or os.path.dirname(os.path.abspath(args.audio_path))
    base = os.path.splitext(os.path.basename(args.audio_path))[0]
    files = SimpleCaptionFormatter().create_caption_package(segments, out_dir, base)
    for k, v in files.items():
        print(f"  {k}: {v}")
    return files


if __name__ == "__main__":
    main()
