"""Headless TTS serving CLI: the dynamic-batching HTTP endpoint over the
port's pipeline, on the card unless `--device cpu` is given.

  python -m vibevoice_tpu_torch.serving --model_path /path/to/VibeVoice-1.5B \\
      --quantize int4 --quantize_tokenizer int4k --quantize_diffusion int4k \\
      --use_fused_stages --port 8000 --max_batch 4 --voices_dir demo/voices

POST /tts {"script": "Speaker 1: ...", "voice": "en-Alice"} -> WAV.
Warms the engines of batch 1, 2 and max_batch at the prompt bucket before
serving (on the card each captures its decode step in a CUDA graph), so no
request pays for a capture.  The port of `scripts/serve.py`.
"""
import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vibevoice_tpu_torch.serving")
    ap.add_argument("--model_path", default=None,
                    help="HF checkpoint dir (tiny random model if omitted — smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--max_new_tokens", type=int, default=256)
    ap.add_argument("--quantize", default=None)
    ap.add_argument("--quantize_tokenizer", default=None)
    ap.add_argument("--quantize_diffusion", default=None,
                    help="int4k: the diffusion head on the fused int4 head kernel")
    ap.add_argument("--use_fused_stages", action="store_true",
                    help="the large-T sigma-VAE stages on the fused stage kernels")
    ap.add_argument("--kv_dtype", default="model")
    ap.add_argument("--ddpm_steps", type=int, default=5)
    ap.add_argument("--algorithm_type", default="sde-dpmsolver++")
    ap.add_argument("--voices_dir", default=None)
    ap.add_argument("--no_warm", action="store_true")
    # /tts/stream buffering policy (reference gradio: first flush at >=30
    # audio-sec buffered, else on a 15 s cadence)
    ap.add_argument("--stream_buffer_sec", type=float, default=30.0)
    ap.add_argument("--stream_cadence_s", type=float, default=15.0)
    args = ap.parse_args(argv)

    import torch
    from ..pipeline import VibeVoiceTTS
    from ..processor.audio import load_audio
    from . import serve

    kw = dict(ddpm_steps=args.ddpm_steps, algorithm_type=args.algorithm_type,
              quantize=args.quantize, quantize_tokenizer=args.quantize_tokenizer,
              quantize_diffusion=args.quantize_diffusion,
              use_fused_stages=args.use_fused_stages, kv_dtype=args.kv_dtype,
              device=args.device)
    if args.model_path:
        tts = VibeVoiceTTS.from_pretrained(args.model_path, **kw)
    else:
        from ..configs import tiny_config
        print("WARNING: no --model_path; tiny random model (smoke only)")
        tts = VibeVoiceTTS.from_random(cfg=tiny_config(vocab_size=320),
                                       dtype=torch.float32, **kw)

    presets = {}
    if args.voices_dir and os.path.isdir(args.voices_dir):
        for f in sorted(os.listdir(args.voices_dir)):
            if f.endswith(".wav"):
                presets[os.path.splitext(f)[0].split("_")[0]] = load_audio(
                    os.path.join(args.voices_dir, f))

    if not args.no_warm:
        sizes = sorted({1, 2, args.max_batch})
        print(f"warming engine buckets {sizes} ...")
        tts.warm(batch_sizes=sizes, max_new_tokens=(args.max_new_tokens,))

    srv = serve(tts, host=args.host, port=args.port, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms,
                default_max_new_tokens=args.max_new_tokens,
                voice_presets=presets,
                stream_buffer_sec=args.stream_buffer_sec,
                stream_cadence_s=args.stream_cadence_s)
    print(f"serving on {args.host}:{srv.port} "
          f"(POST /tts, POST /tts/stream, GET /healthz /metrics)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
