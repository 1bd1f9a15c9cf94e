"""Streaming web UI on the port: up to four speakers from the voice presets,
example scripts, a live generation log, streamed audio with a complete-audio
artifact when generation ends, and a stop button.

The port of `demo/gradio_demo.py`, on the card unless `--device cpu` is
given (gradio is an optional dependency; `create_demo_interface` takes the gradio
module as a parameter, so the Blocks graph also builds on a stub):

  python -m vibevoice_tpu_torch.demo.gradio_demo --model_path /path/to/VibeVoice-1.5B
  python -m vibevoice_tpu_torch.demo.gradio_demo --quantize int4
  python -m vibevoice_tpu_torch.demo.gradio_demo --tiny --device cpu

Generation runs on a worker thread, which owns the card: on the first
request of a shape its engine captures the decode step in a CUDA graph
there.  The UI thread only reads numpy chunks from the `AudioStreamer` and
never touches CUDA.  With a streamer attached `generate` decodes
`stream_chunk` (4) steps between its stop checks, so a stop ends the
stream at most one chunk after the flag is set.
"""
from __future__ import annotations

import argparse
import os
import random
import re
import sys
import threading
import time

import numpy as np

from .inference_from_file import REPO_ROOT, VOICES_DIR

SAMPLE_RATE = 24000
EXAMPLE_MAX_MINUTES = 15
EXAMPLES_DIR = os.path.join(REPO_ROOT, "demo", "text_examples")
GRADIO_MISSING = "gradio is not installed; `pip install gradio` to run the web demo."


def convert_to_16_bit_wav(data: np.ndarray) -> np.ndarray:
    """float waveform -> int16, scaled down first where it exceeds [-1, 1]."""
    data = np.asarray(data, np.float32)
    peak = np.abs(data).max() if data.size else 0.0
    if peak > 1.0:
        data = data / peak
    return (data * 32767).astype(np.int16)


class VibeVoiceDemo:
    def __init__(self, model_path=None, inference_steps: int = 5, cfg_scale: float = 1.3,
                 quantize=None, device="cuda", tiny: bool = False):
        """A `VibeVoiceTTS` on `device` (CUDA unless asked for the CPU) with
        5 steps of the SDE solver, as the production demo runs: from
        `model_path`, else a tiny random fp32 model with `tiny`, else a
        random 1.5B."""
        import torch
        from ..device import resolve_device
        from ..pipeline import VibeVoiceTTS
        device = resolve_device(device)
        kw = dict(ddpm_steps=inference_steps, cfg_scale=cfg_scale,
                  algorithm_type="sde-dpmsolver++", quantize=quantize, device=device)
        if model_path:
            self.tts = VibeVoiceTTS.from_pretrained(model_path, **kw)
        elif tiny:
            from ..configs import tiny_config
            self.tts = VibeVoiceTTS.from_random(cfg=tiny_config(vocab_size=320),
                                                dtype=torch.float32, **kw)
        else:
            self.tts = VibeVoiceTTS.from_random(**kw)
        self.stop_flag = False
        self.is_generating = False
        self.setup_voice_presets()
        self.load_example_scripts()

    # ------------------------------------------------------------------
    def setup_voice_presets(self, voices_dir: str = VOICES_DIR):
        """Voice presets by file stem, from the repo's `demo/voices`."""
        self.voice_presets = {}
        if os.path.isdir(voices_dir):
            for f in sorted(os.listdir(voices_dir)):
                if f.lower().endswith((".wav", ".mp3", ".flac", ".npy")):
                    self.voice_presets.setdefault(os.path.splitext(f)[0],
                                                  os.path.join(voices_dir, f))
        self.available_voices = sorted(self.voice_presets)

    def load_example_scripts(self, examples_dir: str = EXAMPLES_DIR):
        """`[n_speakers, script]` for each `*.txt` of `examples_dir`, skipping
        scripts whose file name declares more than 15 minutes."""
        self.example_scripts = []
        if not os.path.isdir(examples_dir):
            return
        for name in sorted(os.listdir(examples_dir)):
            if not name.lower().endswith(".txt"):
                continue
            m = re.search(r"(\d+)min", name.lower())
            if m and int(m.group(1)) > EXAMPLE_MAX_MINUTES:
                continue
            try:
                with open(os.path.join(examples_dir, name), encoding="utf-8") as f:
                    content = "\n".join(l for l in f.read().strip().split("\n") if l.strip())
            except OSError:
                continue
            if content:
                self.example_scripts.append(
                    [self._get_num_speakers_from_script(content), content])

    @staticmethod
    def _get_num_speakers_from_script(script: str) -> int:
        """Unique speaker count, at most 4."""
        ids = {int(m.group(1))
               for line in script.splitlines()
               if (m := re.match(r"^Speaker\s+(\d+)\s*:", line.strip(), re.IGNORECASE))}
        if not ids:
            return 1
        return min(4, max(len(ids), max(ids) + (1 if 0 in ids else 0)))

    # ------------------------------------------------------------------
    def _resolve_voices(self, speakers, num_speakers: int):
        # a speaker without a preset gets 8 hops of low-level noise, so that
        # random-weight and tiny demos keep their voice prompts short
        fallback = np.random.default_rng(0).normal(
            0, 0.02, 8 * self.tts.cfg.speech_compress_ratio).astype(np.float32)
        voices = []
        for name in list(speakers)[:num_speakers]:
            path = self.voice_presets.get(name or "")
            voices.append(path if path else fallback)
        return voices or [fallback]

    def generate_podcast_streaming(self, num_speakers: int, script: str,
                                   speaker_1=None, speaker_2=None, speaker_3=None,
                                   speaker_4=None, cfg_scale: float = 1.3,
                                   max_new_tokens: int = 512, on_step=None):
        """Yields (streaming_chunk, complete_audio, log, streaming_visible):
        chunks buffered to >=30 s of audio or a 15 s cadence; the last yield
        carries the whole 16-bit waveform."""
        from ..engine.streamer import AudioStreamer
        if not script or not script.strip():
            yield None, None, "Error: please provide a script.", False
            return
        self.stop_flag = False
        self.is_generating = True
        voices = self._resolve_voices(
            (speaker_1, speaker_2, speaker_3, speaker_4), int(num_speakers))
        streamer = AudioStreamer(batch_size=1)
        err, result = [], []

        def run():
            try:
                res, _metrics = self.tts.generate(
                    script, voices, max_new_tokens=max_new_tokens,
                    audio_streamer=streamer,
                    stop_check_fn=lambda: self.stop_flag, on_step=on_step)
                result.append(res)
            except Exception as e:  # surface into the UI loop
                err.append(e)
                streamer.end()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        log = f"Starting generation with {int(num_speakers)} speaker(s), cfg={cfg_scale}..."
        yield None, None, log, True

        buf, pieces, last_yield = [], [], time.time()
        min_samples = SAMPLE_RATE * 30
        for chunk in streamer.get_stream(0):
            if self.stop_flag:
                break
            buf.append(chunk)
            pieces.append(chunk)
            n = sum(len(c) for c in buf)
            total = sum(len(c) for c in pieces)
            if n >= min_samples or (time.time() - last_yield > 15 and n > 0):
                log = f"Streaming... {total / SAMPLE_RATE:.1f}s generated"
                yield (SAMPLE_RATE, np.concatenate(buf)), None, log, True
                buf, last_yield = [], time.time()
        if buf and not self.stop_flag:
            yield (SAMPLE_RATE, np.concatenate(buf)), None, "Flushing final chunk...", True
        # no time limit: the stream has ended (or the stop check fires within
        # a chunk), and a request still gathering its result must not be cut
        # while the next one starts on the same engine
        t.join()
        self.is_generating = False
        if err:
            yield None, None, f"Error: {err[0]}", False
            return
        if self.stop_flag:
            yield None, None, "Generation stopped.", False
            return
        complete = (np.concatenate(pieces) if pieces else
                    (result[0].audio[0] if result and result[0].audio[0] is not None
                     else None))
        if complete is None:
            yield None, None, "No audio was generated.", False
            return
        dur = len(complete) / SAMPLE_RATE
        yield None, (SAMPLE_RATE, convert_to_16_bit_wav(complete)), \
            f"Done: {dur:.1f}s of audio generated.", False

    def stop_audio_generation(self):
        self.stop_flag = True

    def stop(self):
        self.stop_audio_generation()


# ---------------------------------------------------------------------------
# UI graph
# ---------------------------------------------------------------------------

def create_demo_interface(demo_instance: VibeVoiceDemo, gr=None):
    """Build the Blocks graph.  `gr` defaults to the real gradio module; tests
    pass a stub so the graph builds headlessly without the dependency."""
    if gr is None:
        import gradio as gr

    with gr.Blocks(title="VibeVoice — long-form multi-speaker TTS") as ui:
        gr.Markdown("# VibeVoice\nLong-form multi-speaker TTS on the GPU — "
                    "streaming generation with up to 4 speakers.")
        with gr.Row():
            with gr.Column(scale=1):
                num_speakers = gr.Slider(minimum=1, maximum=4, value=2, step=1,
                                         label="Number of speakers")
                speaker_selections = []
                for i in range(4):
                    default = (demo_instance.available_voices[i % max(1, len(demo_instance.available_voices))]
                               if demo_instance.available_voices else None)
                    speaker_selections.append(
                        gr.Dropdown(choices=demo_instance.available_voices,
                                    value=default, label=f"Speaker {i + 1}",
                                    visible=(i < 2)))
                cfg_scale = gr.Slider(minimum=1.0, maximum=2.0, value=1.3, step=0.05,
                                      label="CFG scale")
            with gr.Column(scale=2):
                script_input = gr.Textbox(
                    label="Script", lines=10,
                    placeholder="Speaker 1: ...\nSpeaker 2: ...",
                    value="Speaker 1: Hello and welcome!\nSpeaker 2: Great to be here.")
                with gr.Row():
                    random_example_btn = gr.Button("Random example")
                    generate_btn = gr.Button("Generate", variant="primary")
                    stop_btn = gr.Button("Stop", variant="stop", visible=False)
                streaming_status = gr.Markdown("**Streaming...**", visible=False)
                audio_output = gr.Audio(label="Streaming audio", streaming=True,
                                        autoplay=True)
                complete_audio_output = gr.Audio(label="Complete audio",
                                                 visible=False)
                log_output = gr.Textbox(label="Generation log", lines=8,
                                        interactive=False)

        def update_speaker_visibility(n):
            return [gr.update(visible=(i < int(n))) for i in range(4)]

        num_speakers.change(update_speaker_visibility, [num_speakers],
                            speaker_selections)

        def generate_wrapper(n, script, s1, s2, s3, s4, cfg):
            try:
                yield (None, gr.update(value=None, visible=False),
                       "Starting generation...", gr.update(visible=True),
                       gr.update(visible=False), gr.update(visible=True))
                for stream_chunk, complete, log, streaming in \
                        demo_instance.generate_podcast_streaming(
                            n, script, s1, s2, s3, s4, cfg_scale=cfg):
                    if complete is not None:
                        yield (None, gr.update(value=complete, visible=True), log,
                               gr.update(visible=False), gr.update(visible=True),
                               gr.update(visible=False))
                    else:
                        yield (stream_chunk, gr.update(visible=False), log,
                               gr.update(visible=streaming),
                               gr.update(visible=False), gr.update(visible=True))
            except Exception as e:
                yield (None, gr.update(value=None, visible=False), f"Error: {e}",
                       gr.update(visible=False), gr.update(visible=True),
                       gr.update(visible=False))

        gen_outputs = [audio_output, complete_audio_output, log_output,
                       streaming_status, generate_btn, stop_btn]
        generate_btn.click(
            lambda: (None, gr.update(value=None, visible=False)),
            [], [audio_output, complete_audio_output], queue=False,
        ).then(
            lambda: (gr.update(visible=False), gr.update(visible=True)),
            [], [generate_btn, stop_btn], queue=False,
        ).then(
            generate_wrapper,
            [num_speakers, script_input] + speaker_selections + [cfg_scale],
            gen_outputs, queue=True,
        )

        def stop_handler():
            demo_instance.stop_audio_generation()
            return ("Generation stopped.", gr.update(visible=False),
                    gr.update(visible=True), gr.update(visible=False))

        stop_btn.click(stop_handler, [],
                       [log_output, streaming_status, generate_btn, stop_btn],
                       queue=False)

        def load_random_example():
            if not demo_instance.example_scripts:
                return 2, "Speaker 1: Hello!\nSpeaker 2: Hi!"
            n, script = random.choice(demo_instance.example_scripts)
            return n, script

        random_example_btn.click(load_random_example, [],
                                 [num_speakers, script_input], queue=False)
    return ui


def demo_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags both web demos take."""
    ap.add_argument("--model_path", type=str, default=None)
    ap.add_argument("--inference_steps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random fp32 model (smoke test, noise output)")
    return ap


def import_gradio():
    """The gradio module; exits 1 with a message where it is not installed."""
    try:
        import gradio as gr
    except ImportError:
        print(GRADIO_MISSING)
        sys.exit(1)
    return gr


def main(argv=None):
    ap = demo_args(argparse.ArgumentParser(prog="python -m vibevoice_tpu_torch.demo.gradio_demo"))
    ap.add_argument("--quantize", type=str, default=None, choices=[None, "int8", "int4"])
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--share", action="store_true")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)
    gr = import_gradio()

    demo_obj = VibeVoiceDemo(args.model_path, args.inference_steps, quantize=args.quantize,
                             device=device, tiny=args.tiny)
    ui = create_demo_interface(demo_obj, gr)
    ui.queue().launch(server_port=args.port, share=args.share)


if __name__ == "__main__":
    main()
