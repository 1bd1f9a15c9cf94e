"""CLI with Whisper-based captions; falls back to script-timing captions when
no whisper backend is installed.

The port of `demo/inference_with_captions.py`, on the card unless
`--device cpu` is given (the whisper model too):

  python -m vibevoice_tpu_torch.demo.inference_with_captions \\
      --txt_path demo/text_examples/2p_dialogue.txt --model_path /path/to/VibeVoice-1.5B
"""
from __future__ import annotations

import argparse
import os

from .inference_from_file import (VoiceMapper, load_tts, model_args, neutral_voice,
                                  parse_txt_script)


def main(argv=None):
    ap = model_args(argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.demo.inference_with_captions"))
    ap.add_argument("--txt_path", type=str, required=True)
    ap.add_argument("--output_dir", type=str, default="./outputs")
    ap.add_argument("--whisper_model", type=str, default="base")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..processor.captions_processor import VibeVoiceProcessorWithCaptions
    device = resolve_device(args.device)

    with open(args.txt_path, encoding="utf-8") as f:
        script, speakers = parse_txt_script(f.read())

    tts = load_tts(args, device)

    mapper = VoiceMapper(args.voices_dir)
    voices = [mapper.get_voice_path(n) or neutral_voice() for n in speakers]

    res, metrics = tts.generate(script, voices, max_new_tokens=args.max_new_tokens)
    if res.audio[0] is None:
        print("no audio generated")
        return {"files": None, "metrics": metrics}

    proc = VibeVoiceProcessorWithCaptions(
        tts.tokenizer, speech_tok_compress_ratio=tts.cfg.speech_compress_ratio,
        whisper_model_size=args.whisper_model, whisper_device=device.type)
    enc = tts.processor(script, voices)
    base = os.path.splitext(os.path.basename(args.txt_path))[0]
    out = os.path.join(args.output_dir, f"{base}.wav")
    files = proc.save_audio_with_captions(res.audio[0], out, enc.parsed_scripts[0])
    for k, v in files.items():
        print(f"  {k}: {v}")
    print(f"RTF={metrics['rtf']:.3f}")
    return {"files": files, "metrics": metrics}


if __name__ == "__main__":
    main()
