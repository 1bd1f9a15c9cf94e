"""Whisper-based caption generation (optional dependency).

The port's own copy of `vibevoice_tpu/caption/whisper.py`, the equivalent of
the reference's `vibevoice/caption/caption_generator.py:18-311` /
`caption_formatter.py:16-247`: transcribe generated audio with
openai-whisper or faster-whisper for exact word timings, optionally matching
against the known script.  Gated on import — absent backends raise a clear
error and callers fall back to `SimpleCaptionGenerator`.  The STT model runs
on CUDA unless `device="cpu"` is given (the port's device rule).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .simple import CaptionSegment, SimpleCaptionFormatter


def _backend():
    try:
        import faster_whisper  # type: ignore
        return "faster_whisper"
    except ImportError:
        pass
    try:
        import whisper  # type: ignore
        return "whisper"
    except ImportError:
        return None


class CaptionGenerator:
    """STT-based captions; model sizes tiny/base/small/medium/large."""

    def __init__(self, model_size: str = "base", device: str = "cuda"):
        self.model_size = model_size
        self.device = device
        self._model = None
        self._kind = _backend()
        if self._kind is None:
            raise ImportError(
                "No whisper backend installed (pip install openai-whisper or "
                "faster-whisper); use SimpleCaptionGenerator instead.")

    def _load(self):
        if self._model is not None:
            return
        if self._kind == "faster_whisper":
            from faster_whisper import WhisperModel
            self._model = WhisperModel(self.model_size, device=self.device,
                                       compute_type="int8")
        else:
            import whisper
            self._model = whisper.load_model(self.model_size, device=self.device)

    def transcribe(self, audio_path: str, word_timestamps: bool = True) -> List[CaptionSegment]:
        self._load()
        segments: List[CaptionSegment] = []
        if self._kind == "faster_whisper":
            segs, _ = self._model.transcribe(audio_path, word_timestamps=word_timestamps)
            for s in segs:
                segments.append(CaptionSegment(s.start, s.end, s.text.strip()))
        else:
            result = self._model.transcribe(audio_path, word_timestamps=word_timestamps)
            for s in result["segments"]:
                segments.append(CaptionSegment(s["start"], s["end"], s["text"].strip()))
        return segments

    # -- script matching (parity with the reference's structured matcher,
    #    caption_generator.py:245-311; golden-tested in
    #    tests/test_caption_parity.py) --------------------------------------

    @staticmethod
    def parse_script_segments(script: str) -> List[dict]:
        """Parse 'Speaker N: text' lines into matcher segments
        (ref _parse_script_segments :245-268: case-insensitive regex,
        blank/unmatched lines dropped, char length recorded)."""
        import re
        segments = []
        for line in script.strip().split("\n"):
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^Speaker\s+(\d+)\s*:\s*(.*)$", line, re.IGNORECASE)
            if m and m.group(2).strip():
                text = m.group(2).strip()
                segments.append({"speaker_id": int(m.group(1)), "text": text,
                                 "length": len(text)})
        return segments

    @staticmethod
    def match_transcription_to_script(transcription_segments: Sequence[dict],
                                      script_segments: Sequence[dict],
                                      speaker_mapping: Optional[dict] = None) -> List[dict]:
        """Attach speakers to transcribed segments (ref
        _match_transcription_to_script :270-311): for EACH transcription
        segment take the script segment with the highest word-overlap
        similarity |A∩B| / max(|A|, |B|) over the WHOLE script (no window,
        no position advance); no match above 0 -> speaker_id 0."""
        out = []
        for seg in transcription_segments:
            trans_text = seg.get("text", "").strip().lower()
            trans_words = set(trans_text.split())
            best, best_score = None, 0
            for sseg in script_segments:
                script_words = set(sseg["text"].strip().lower().split())
                if trans_words and script_words:
                    overlap = len(trans_words & script_words)
                    similarity = overlap / max(len(trans_words), len(script_words))
                    if similarity > best_score:
                        best_score, best = similarity, sseg
            sid = best["speaker_id"] if best else 0
            name = (speaker_mapping.get(sid, f"Speaker {sid}") if speaker_mapping
                    else f"Speaker {sid}")
            out.append({
                "start_time": seg.get("start", 0.0),
                "end_time": seg.get("end", 0.0),
                "text": seg.get("text", "").strip(),
                "speaker_id": sid,
                "speaker_name": name,
                "confidence": seg.get("no_speech_prob", 0.0),
            })
        return out

    def generate_captions_for_script(self, audio_path: str, original_script: str,
                                     speaker_mapping: Optional[dict] = None) -> dict:
        """Transcribe + speaker-match against the script (ref
        generate_captions_for_script :205-243)."""
        segments = self.transcribe(audio_path)
        trans = [{"text": s.text, "start": s.start, "end": s.end} for s in segments]
        script_segments = self.parse_script_segments(original_script)
        matched = self.match_transcription_to_script(trans, script_segments,
                                                     speaker_mapping)
        return {
            "caption_segments": matched,
            "speaker_mapping": speaker_mapping or {},
            "total_duration": max((s.end for s in segments), default=0.0),
        }

    def match_speakers(self, segments: Sequence[CaptionSegment],
                       script_lines: Sequence[Tuple[str, str]]) -> List[CaptionSegment]:
        """CaptionSegment-level convenience over the reference matcher."""
        script_segments = [
            {"speaker_id": i, "text": text, "length": len(text)}
            for i, (_, text) in enumerate(script_lines)]
        trans = [{"text": s.text, "start": s.start, "end": s.end} for s in segments]
        matched = self.match_transcription_to_script(trans, script_segments)
        out = []
        for seg, m in zip(segments, matched):
            sid = m["speaker_id"]
            speaker = script_lines[sid][0] if 0 <= sid < len(script_lines) else None
            out.append(CaptionSegment(seg.start, seg.end, seg.text, speaker))
        return out


CaptionFormatter = SimpleCaptionFormatter  # same emitters serve both paths

__all__ = ["CaptionGenerator", "CaptionFormatter"]
