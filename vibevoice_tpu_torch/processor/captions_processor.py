"""Caption-enabled processors.

The port's own copy of `vibevoice_tpu/processor/captions_processor.py`, the
equivalents of the reference's caption processor subclasses
(`vibevoice/processor/vibevoice_processor_simple_captions.py:23-356` and
`vibevoice_processor_with_captions.py:22-298`), on the port's
`VibeVoiceProcessor`: save generated audio together with a full caption
package (SRT/VTT/JSON/transcript/timing).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..caption.simple import SimpleCaptionFormatter, SimpleCaptionGenerator
from .processor import VibeVoiceProcessor


class VibeVoiceProcessorSimpleCaptions(VibeVoiceProcessor):
    """Script-timing captions without STT (ref ..._simple_captions.py:23)."""

    def __init__(self, *args, caption_generator: Optional[SimpleCaptionGenerator] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.caption_generator = caption_generator or SimpleCaptionGenerator()
        self.caption_formatter = SimpleCaptionFormatter()

    def generate_captions_for_audio(self, parsed_script: Sequence[Tuple[int, str]],
                                    duration: float, audio_path: Optional[str] = None):
        """parsed_script: [(speaker_id, text)] from processor output."""
        lines = [(f"Speaker {sid + 1}", text.strip()) for sid, text in parsed_script]
        return self.caption_generator.generate(lines, duration, audio_path)

    def save_audio_with_captions(self, audio: np.ndarray, output_path: str,
                                 parsed_script: Sequence[Tuple[int, str]],
                                 caption_formats: Sequence[str] = ("srt", "vtt", "json"),
                                 ) -> Dict[str, str]:
        """Write wav + caption package next to it (ref :74-218)."""
        path = self.save_audio(audio, output_path)
        duration = len(np.asarray(audio).reshape(-1)) / self.sampling_rate
        segments = self.generate_captions_for_audio(parsed_script, duration, path)
        out_dir = os.path.dirname(os.path.abspath(output_path)) or "."
        base = os.path.splitext(os.path.basename(output_path))[0]
        files = self.caption_formatter.create_caption_package(segments, out_dir, base)
        files["wav"] = path
        return files


class VibeVoiceProcessorWithCaptions(VibeVoiceProcessor):
    """Whisper-backed captions (ref ..._with_captions.py:22); lazily loads the
    STT model (on `whisper_device`, CUDA unless "cpu" is given), falls back to
    script-timing when no whisper backend exists."""

    def __init__(self, *args, whisper_model_size: str = "base", whisper_device: str = "cuda",
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.whisper_model_size = whisper_model_size
        self.whisper_device = whisper_device
        self._stt = None
        self.caption_formatter = SimpleCaptionFormatter()

    def _get_stt(self):
        if self._stt is None:
            from ..caption.whisper import CaptionGenerator
            self._stt = CaptionGenerator(self.whisper_model_size, device=self.whisper_device)
        return self._stt

    def save_audio_with_captions(self, audio, output_path: str,
                                 parsed_script=None, **kw) -> Dict[str, str]:
        path = self.save_audio(audio, output_path)
        out_dir = os.path.dirname(os.path.abspath(output_path)) or "."
        base = os.path.splitext(os.path.basename(output_path))[0]
        try:
            segments = self._get_stt().transcribe(path)
            if parsed_script:
                lines = [(f"Speaker {sid + 1}", t.strip()) for sid, t in parsed_script]
                segments = self._get_stt().match_speakers(segments, lines)
        except ImportError:
            # no whisper backend — script-timing fallback
            duration = len(np.asarray(audio).reshape(-1)) / self.sampling_rate
            gen = SimpleCaptionGenerator()
            lines = [(f"Speaker {sid + 1}", t.strip()) for sid, t in (parsed_script or [])]
            segments = gen.generate(lines, duration, path)
        files = self.caption_formatter.create_caption_package(segments, out_dir, base)
        files["wav"] = path
        return files


__all__ = ["VibeVoiceProcessorSimpleCaptions", "VibeVoiceProcessorWithCaptions"]
