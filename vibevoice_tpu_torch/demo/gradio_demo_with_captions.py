"""Streaming web UI with live captions on the port: the four-speaker
streaming interface of `gradio_demo` plus a live-caption panel that follows
the generated audio, and a caption package (SRT/VTT/JSON) beside the
complete audio.

The port of `demo/gradio_demo_with_captions.py`, on the card unless
`--device cpu` is given:

  python -m vibevoice_tpu_torch.demo.gradio_demo_with_captions --model_path /path/to/VibeVoice-1.5B
  python -m vibevoice_tpu_torch.demo.gradio_demo_with_captions --tiny --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from .gradio_demo import VibeVoiceDemo, demo_args, import_gradio


class VibeVoiceDemoWithCaptions(VibeVoiceDemo):
    def _script_lines(self, script: str):
        parsed = self.tts.processor._parse_script(script)
        return [(f"Speaker {sid + 1}", t.strip()) for sid, t in parsed]

    def _script_captions(self, script: str, duration: float):
        from ..caption.simple import SimpleCaptionGenerator
        return SimpleCaptionGenerator().generate(self._script_lines(script), duration)

    def generate_with_captions(self, num_speakers, script, speaker_1=None,
                               speaker_2=None, speaker_3=None, speaker_4=None,
                               cfg_scale: float = 1.3, max_new_tokens: int = 512):
        """Yields (stream_chunk, complete_audio, log, streaming_visible,
        caption_text, caption_files).

        Live captions come from the engine's emitted-frame clock: a
        `FrameClockCaptionTracker` fed each decode step's tokens and frames
        (`generate(on_step=...)`, on the worker thread, as numpy) knows which
        speech segment is being generated and its start and end times.  The
        final package takes the same timings (the words-per-minute ladder
        only where the emitted turns did not match the script), so the
        streamed captions and the SRT/VTT/JSON agree."""
        from ..caption.simple import FrameClockCaptionTracker
        tracker = FrameClockCaptionTracker(
            self._script_lines(script),
            speech_end_id=self.tts.tokenizer.speech_end_id,
            hop=self.tts.cfg.speech_compress_ratio)
        self._caption_tracker = tracker  # exposed for tests

        for stream, complete, log, streaming in self.generate_podcast_streaming(
                num_speakers, script, speaker_1, speaker_2, speaker_3, speaker_4,
                cfg_scale=cfg_scale, max_new_tokens=max_new_tokens,
                on_step=tracker.update):
            caption, files = "", None
            if stream is not None:
                caption = tracker.current
            if complete is not None:
                files = self._caption_package(script, complete, tracker)
            yield stream, complete, log, streaming, caption, files

    def _caption_package(self, script: str, complete, tracker=None):
        """The caption files: the engine clock's timings where the emitted
        turns matched the script, the words-per-minute ladder otherwise."""
        from ..caption.simple import SimpleCaptionFormatter
        sr, audio = complete
        segments = tracker.segments() if tracker is not None else None
        if segments is None:
            segments = self._script_captions(script, len(audio) / sr)
        out_dir = tempfile.mkdtemp(prefix="vibevoice_captions_")
        files = SimpleCaptionFormatter().create_caption_package(
            segments, out_dir, "podcast")
        return [files["srt"], files["vtt"], files["json"]]


def create_demo_interface_with_captions(demo_instance, gr=None):
    """The full interface plus live-caption panel and caption downloads."""
    if gr is None:
        import gradio as gr

    with gr.Blocks(title="VibeVoice — streaming TTS with live captions") as ui:
        gr.Markdown("# VibeVoice with live captions")
        with gr.Row():
            with gr.Column(scale=1):
                num_speakers = gr.Slider(minimum=1, maximum=4, value=2, step=1,
                                         label="Number of speakers")
                speaker_selections = [
                    gr.Dropdown(choices=demo_instance.available_voices,
                                value=(demo_instance.available_voices[i % max(1, len(demo_instance.available_voices))]
                                       if demo_instance.available_voices else None),
                                label=f"Speaker {i + 1}", visible=(i < 2))
                    for i in range(4)]
                cfg_scale = gr.Slider(minimum=1.0, maximum=2.0, value=1.3,
                                      step=0.05, label="CFG scale")
            with gr.Column(scale=2):
                script_input = gr.Textbox(label="Script", lines=10,
                                          value="Speaker 1: Hello!\nSpeaker 2: Hi there.")
                with gr.Row():
                    generate_btn = gr.Button("Generate", variant="primary")
                    stop_btn = gr.Button("Stop", variant="stop", visible=False)
                audio_output = gr.Audio(label="Streaming audio", streaming=True,
                                        autoplay=True)
                live_caption = gr.Textbox(label="Live caption", interactive=False)
                complete_audio_output = gr.Audio(label="Complete audio", visible=False)
                caption_files = gr.File(label="Caption package (SRT/VTT/JSON)",
                                        visible=False)
                log_output = gr.Textbox(label="Generation log", lines=6,
                                        interactive=False)

        num_speakers.change(
            lambda n: [gr.update(visible=(i < int(n))) for i in range(4)],
            [num_speakers], speaker_selections)

        def wrapper(n, script, s1, s2, s3, s4, cfg):
            for stream, complete, log, streaming, caption, files in \
                    demo_instance.generate_with_captions(n, script, s1, s2, s3, s4,
                                                         cfg_scale=cfg):
                if complete is not None:
                    yield (None, gr.update(value=complete, visible=True), log,
                           caption, gr.update(value=files, visible=True),
                           gr.update(visible=True), gr.update(visible=False))
                else:
                    yield (stream, gr.update(visible=False), log, caption,
                           gr.update(visible=False),
                           gr.update(visible=False), gr.update(visible=True))

        generate_btn.click(
            wrapper,
            [num_speakers, script_input] + speaker_selections + [cfg_scale],
            [audio_output, complete_audio_output, log_output, live_caption,
             caption_files, generate_btn, stop_btn], queue=True)
        stop_btn.click(lambda: demo_instance.stop_audio_generation(), [], [],
                       queue=False)
    return ui


def main(argv=None):
    ap = demo_args(argparse.ArgumentParser(
        prog="python -m vibevoice_tpu_torch.demo.gradio_demo_with_captions"))
    ap.add_argument("--port", type=int, default=7861)
    args = ap.parse_args(argv)

    from ..device import resolve_device
    device = resolve_device(args.device)
    gr = import_gradio()

    demo_obj = VibeVoiceDemoWithCaptions(args.model_path, args.inference_steps,
                                         device=device, tiny=args.tiny)
    ui = create_demo_interface_with_captions(demo_obj, gr)
    ui.queue().launch(server_port=args.port)


if __name__ == "__main__":
    main()
