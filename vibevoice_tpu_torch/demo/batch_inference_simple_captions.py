"""Batch inference with script-timing captions: glob a txt dir, batch the
scripts, one padded `generate` per batch, a wav and its captions per file.

The port of `demo/batch_inference_simple_captions.py` (the reference's
`demo/batch_inference_simple_captions.py:180-402`): plain in-process batching
on one device, the card unless `--device cpu` is given.  Its stdout ends in
one `Saved audio to: <file>` line per saved wav, which shell pipelines grep:

  python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions \\
      --model_path /path/to/VibeVoice-1.5B --input_dir scripts/ --batch_size 4
"""
from __future__ import annotations

import argparse
import glob
import os
import time

from .inference_from_file import VoiceMapper, load_tts, model_args, neutral_voice


def create_batches(files, batch_size):
    return [files[i:i + batch_size] for i in range(0, len(files), batch_size)]


def main(argv=None):
    ap = model_args(argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions"))
    # file selection mirrors the reference CLI (batch_inference_simple_
    # captions.py:45-62): explicit --txt_files overrides the directory glob,
    # --txt_path runs a single file; --txt_dir is the reference's name for
    # --input_dir
    ap.add_argument("--input_dir", "--txt_dir", dest="input_dir", type=str,
                    default=None)
    ap.add_argument("--txt_files", type=str, nargs="+", default=None)
    ap.add_argument("--txt_path", type=str, default=None)
    ap.add_argument("--output_dir", type=str, default="./outputs")
    ap.add_argument("--batch_size", type=int, default=8)
    # accepted for reference shell-script compatibility (:71-115): captions
    # are always script-timed here
    ap.add_argument("--speaker_names", type=str, nargs="+", default=None)
    ap.add_argument("--generate_captions", action="store_true")
    ap.add_argument("--caption_formats", type=str, nargs="+", default=["srt"])
    ap.add_argument("--words_per_minute", type=int, default=150)
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..processor.captions_processor import VibeVoiceProcessorSimpleCaptions
    device = resolve_device(args.device)

    if args.txt_files:
        files = list(args.txt_files)
    elif args.txt_path:
        files = [args.txt_path]
    elif args.input_dir:
        files = sorted(glob.glob(os.path.join(args.input_dir, "*.txt")))
    else:
        ap.error("one of --txt_files / --txt_path / --input_dir is required")
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        print(f"missing input files: {missing}")
        return []
    if not files:
        print(f"no .txt files in {args.input_dir}")
        return []
    print(f"{len(files)} scripts, batch size {args.batch_size}")

    tts = load_tts(args, device)

    cap_proc = VibeVoiceProcessorSimpleCaptions(
        tts.tokenizer, speech_tok_compress_ratio=tts.cfg.speech_compress_ratio)
    mapper = VoiceMapper(args.voices_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    total_audio, total_wall = 0.0, 0.0
    saved_files = []
    for bi, batch_files in enumerate(create_batches(files, args.batch_size)):
        scripts = []
        for f in batch_files:
            with open(f, encoding="utf-8") as fh:
                scripts.append(fh.read())
        voices = [[mapper.get_voice_path("1") or neutral_voice()] for _ in batch_files]
        t0 = time.time()
        res, metrics = tts.generate(scripts, voices, max_new_tokens=args.max_new_tokens)
        dt = time.time() - t0
        total_audio += metrics["audio_sec"]
        total_wall += dt
        enc = tts.processor(scripts, voices)
        for i, f in enumerate(batch_files):
            base = os.path.splitext(os.path.basename(f))[0]
            if res.audio[i] is None:
                print(f"  [{base}] no audio")
                continue
            out = os.path.join(args.output_dir, f"{base}.wav")
            files_out = cap_proc.save_audio_with_captions(
                res.audio[i], out, enc.parsed_scripts[i])
            print(f"  [{base}] {len(res.audio[i])/24000:.1f}s -> {files_out['wav']}")
            saved_files.append(files_out["wav"])
        print(f"batch {bi}: {dt:.1f}s wall, RTF {metrics['rtf']:.2f}")
    print(f"TOTAL: {total_audio:.1f}s audio in {total_wall:.1f}s "
          f"(RTF {total_audio/max(total_wall,1e-9):.2f})")
    # shell pipelines grep for this exact line (ref :389-396)
    for f in saved_files:
        print(f"Saved audio to: {f}")
    return saved_files


if __name__ == "__main__":
    main()
