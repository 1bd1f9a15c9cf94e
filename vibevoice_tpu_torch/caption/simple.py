"""Script-based caption generation (no STT required).

The port's own copy of `vibevoice_tpu/caption/simple.py`, which re-implements
the reference caption pipeline (`vibevoice/caption/simple_caption_generator.py:28-1305`,
`simple_caption_formatter.py:16-290`): split the known script into caption
segments, estimate timing from duration via a words-per-minute heuristic with
speaker-change pauses, optionally refine with ffmpeg `silencedetect` sentence
boundaries or faster-whisper word alignment when available, then emit
SRT / VTT / JSON / transcript formats.  Pure Python on the host;
`FrameClockCaptionTracker` reads the port's `StepOutput`, whose fields
`generate(on_step=...)` hands over as numpy.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class CaptionSegment:
    start: float
    end: float
    text: str
    speaker: Optional[str] = None

    def to_dict(self):
        return {"start": round(self.start, 3), "end": round(self.end, 3),
                "text": self.text, "speaker": self.speaker}


_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    parts = [p.strip() for p in _SENT_RE.split(text.strip()) if p.strip()]
    return parts or ([text.strip()] if text.strip() else [])


def chunk_words(sentence: str, max_words: int = 15) -> List[str]:
    """Split long sentences into <=max_words chunks at word boundaries
    (ref :166: <=15-word chunking)."""
    words = sentence.split()
    if len(words) <= max_words:
        return [sentence]
    return [" ".join(words[i:i + max_words]) for i in range(0, len(words), max_words)]


def _word_count(text: str) -> int:
    return len(text.split())


class SimpleCaptionGenerator:
    """Align a script to an audio duration (ref :28-1305).

    Alignment ladder, matching the reference's `_calculate_timing` (:233-260):
      1. faster-whisper word-level alignment (when the optional dep +
         audio file are available) — `_align_with_faster_whisper` :421-652
      2. ffmpeg silencedetect sentence-boundary alignment with word-count
         proportional mapping — `_detect_audio_aligned_segments` :654-1100
      3. words-per-minute heuristic with speaker pauses and the reference's
         progressive-slowdown model — `_calculate_timing` :265-419
    """

    def __init__(self, words_per_minute: float = 120.0,
                 speaker_change_pause: float = 1.0,
                 segment_pause: float = 0.8,
                 max_words_per_caption: int = 15,
                 min_segment_duration: float = 1.0,
                 silence_threshold_db: float = -30.0,
                 min_silence_duration: float = 0.25,
                 min_detected_segment_duration: float = 0.6,
                 silence_calibration_offset: float = 3.0,
                 whisper_model: str = "base"):
        self.wpm = words_per_minute
        self.speaker_change_pause = speaker_change_pause  # ref pause_between_speakers
        self.segment_pause = segment_pause                # ref pause_between_segments
        self.max_words = max_words_per_caption
        self.min_segment_duration = min_segment_duration
        self.silence_threshold_db = silence_threshold_db
        self.min_silence_duration = min_silence_duration
        self.min_detected_segment_duration = min_detected_segment_duration
        # the reference shifts silence-derived timings forward by a fixed
        # 3 s "calibration" (ref :989-1005); configurable here
        self.silence_calibration_offset = silence_calibration_offset
        self.whisper_model = whisper_model

    # ------------------------------------------------------------------
    def generate(self, script_lines: Sequence[Tuple[str, str]], duration: float,
                 audio_path: Optional[str] = None) -> List[CaptionSegment]:
        """script_lines: [(speaker, text)]; duration: audio seconds."""
        chunks = self._chunk_script(script_lines)
        if audio_path and os.path.exists(audio_path):
            words = self._transcribe_words(audio_path)
            if words:
                return self._segments_from_words(chunks, words, duration)
            audio_segs = self._audio_aligned_segments(audio_path, duration, len(chunks))
            if audio_segs:
                return self._segments_from_word_count(chunks, audio_segs, duration)
        return self._calculate_timing(chunks, duration)

    # ------------------------------------------------------------------
    def _chunk_script(self, script_lines) -> List[Tuple[str, str]]:
        chunks: List[Tuple[str, str]] = []
        for speaker, text in script_lines:
            for sent in split_sentences(text):
                for chunk in chunk_words(sent, self.max_words):
                    chunks.append((speaker, chunk))
        return chunks

    # ------------------------------------------------------------------
    # rung 3: WPM heuristic with progressive slowdown (ref :265-419)
    # ------------------------------------------------------------------
    def _calculate_timing(self, chunks, duration: float) -> List[CaptionSegment]:
        """Word-count-proportional timing with the reference's progressive
        slowdown: pauses grow up to +50% in the second half (:310-323),
        segment durations grow up to +60% from 20% through (:333-345),
        everything rescaled to fit the true duration exactly (:348-356)."""
        if not chunks:
            return []
        n = len(chunks)
        total_words = sum(_word_count(t) for _, t in chunks) or 1

        pauses = []
        for i in range(n - 1):
            base = (self.speaker_change_pause if chunks[i + 1][0] != chunks[i][0]
                    else self.segment_pause)
            if i >= n * 0.5:
                progress = (i - n * 0.5) / (n * 0.5)
                base *= 1.0 + progress * 0.5
            pauses.append(base)
        available = duration - sum(pauses)

        durs = []
        for i, (_, text) in enumerate(chunks):
            d = available * _word_count(text) / total_words
            if i >= n * 0.2:
                progress = (i - n * 0.2) / (n * 0.8)
                d *= 1.0 + progress * 0.60
            durs.append(max(self.min_segment_duration, d))

        total = sum(durs) + sum(pauses)
        if total > 0 and abs(total - duration) > 0.01:
            scale = duration / total
            durs = [d * scale for d in durs]
            pauses = [p * scale for p in pauses]

        out: List[CaptionSegment] = []
        t = 0.0
        for i, (speaker, text) in enumerate(chunks):
            end = duration if i == n - 1 else min(t + durs[i], duration)
            out.append(CaptionSegment(start=t, end=end, text=text, speaker=speaker))
            t = end
            if i < n - 1:
                t += min(pauses[i], max(0.0, duration - t))
        out[-1].end = duration
        return out

    # ------------------------------------------------------------------
    # rung 2: silencedetect sentence boundaries (ref :654-1100)
    # ------------------------------------------------------------------
    def _detect_silences(self, audio_path: str) -> Optional[List[Tuple[float, float]]]:
        """ffmpeg silencedetect (ref :656-700); None when ffmpeg is absent."""
        if shutil.which("ffmpeg") is None:
            return None
        cmd = ["ffmpeg", "-i", audio_path, "-af",
               f"silencedetect=noise={self.silence_threshold_db}dB:d={self.min_silence_duration}",
               "-f", "null", "-"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (subprocess.TimeoutExpired, OSError):
            return None
        silences, start = [], None
        for line in proc.stderr.splitlines():
            ms = re.search(r"silence_start:\s*([\d.]+)", line)
            me = re.search(r"silence_end:\s*([\d.]+)", line)
            if ms:
                start = float(ms.group(1))
            elif me and start is not None:
                silences.append((start, float(me.group(1))))
                start = None
        return silences

    def _audio_aligned_segments(self, audio_path: str, duration: float,
                                target: int) -> Optional[List[Tuple[float, float]]]:
        silences = self._detect_silences(audio_path)
        if not silences:
            return None
        return self.speech_segments_for_sentences(silences, duration, target)

    def speech_segments_for_sentences(self, silences: List[Tuple[float, float]],
                                      duration: float,
                                      target: int) -> List[Tuple[float, float]]:
        """Sentence-per-speech-segment assignment between silences
        (ref _detect_audio_aligned_segments :700-786)."""
        speech: List[Tuple[float, float]] = []
        if silences[0][0] > 0:
            speech.append((0.0, silences[0][0]))
        for i, (s_start, s_end) in enumerate(silences):
            nxt = silences[i + 1][0] if i + 1 < len(silences) else None
            if nxt is not None:
                speech.append((s_end, nxt))
            elif s_end < duration:
                speech.append((s_end, duration))
        if not speech:
            speech.append((0.0, duration))

        # drop/merge segments shorter than the detection floor (ref :740-755)
        filtered: List[Tuple[float, float]] = []
        for seg in speech:
            if seg[1] - seg[0] >= self.min_detected_segment_duration or not filtered:
                filtered.append(seg)
            else:
                filtered[-1] = (filtered[-1][0], seg[1])
        # merge adjacent pairs that are BOTH short (ref :758-770)
        i = 0
        while i < len(filtered) - 1:
            if (filtered[i][1] - filtered[i][0] < 1.5
                    and filtered[i + 1][1] - filtered[i + 1][0] < 1.5):
                filtered[i] = (filtered[i][0], filtered[i + 1][1])
                filtered.pop(i + 1)
            else:
                i += 1

        if len(filtered) == target:
            return filtered
        return self._map_silences_to_sentences(silences, filtered, target, duration)

    def _map_silences_to_sentences(self, silences, speech_segments, target: int,
                                   duration: float) -> List[Tuple[float, float]]:
        """Boundary selection when silence count != sentence count
        (ref :786-860): sentence boundaries at silence STARTS; keep the
        longest silences when there are too many, interpolate uniformly when
        too few.  (The reference additionally hardcodes a boundary at ~213 s
        for one specific podcast, :816-834 — a script-specific patch, not
        mirrored.)"""
        if len(speech_segments) == target:
            return speech_segments
        starts = sorted(s[0] for s in silences)
        if len(starts) > target - 1:
            by_len = sorted(((e - s, s) for s, e in silences), reverse=True)
            starts = sorted(s for _, s in by_len[:target - 1])
        elif len(starts) < target - 1:
            step = duration / target
            starts = [i * step for i in range(1, target)]
        segs: List[Tuple[float, float]] = []
        cursor = 0.0
        for b in starts:
            if b > cursor:
                segs.append((cursor, b))
            cursor = b
        if cursor < duration:
            segs.append((cursor, duration))
        return segs

    def _segments_from_word_count(self, chunks, audio_segments,
                                  duration: float) -> List[CaptionSegment]:
        """Word-count-proportional mapping of text chunks onto the detected
        speech timeline (ref _build_segments_from_audio_alignment_with_word_count
        :967-1073).  The calibration offset is applied twice, exactly like the
        reference — once to the audio segments (:997-1003) and again to the
        final timings (:1045-1047)."""
        if len(audio_segments) > len(chunks):
            audio_segments = audio_segments[:len(chunks)]
        audio_segments = list(audio_segments)
        while len(audio_segments) < len(chunks):
            last = audio_segments[-1]
            audio_segments.append((last[1], last[1] + 1.0))

        off = self.silence_calibration_offset
        audio_segments = [(max(0.0, s + off), min(duration, e + off))
                          for s, e in audio_segments]
        total_words = sum(_word_count(t) for _, t in chunks) or 1
        total_speech = sum(e - s for s, e in audio_segments)

        out: List[CaptionSegment] = []
        cum = 0.0
        for speaker, text in chunks:
            seg_dur = total_speech * _word_count(text) / total_words
            t0, t1 = cum, cum + seg_dur
            actual_start = actual_end = 0.0
            cursor = 0.0
            for a_start, a_end in audio_segments:
                a_dur = a_end - a_start
                if cursor <= t0 < cursor + a_dur:
                    actual_start = a_start + (t0 - cursor)
                if cursor < t1 <= cursor + a_dur:
                    actual_end = a_start + (t1 - cursor)
                    break
                cursor += a_dur
            if actual_end == 0.0:
                actual_end = min(audio_segments[-1][1], actual_start + seg_dur)
            out.append(CaptionSegment(
                start=max(0.0, actual_start + off),
                end=min(duration, actual_end + off),
                text=text, speaker=speaker))
            cum += seg_dur
        if out:
            out[-1].end = audio_segments[-1][1]
        return out

    # ------------------------------------------------------------------
    # rung 1: faster-whisper word-level alignment (ref :421-652)
    # ------------------------------------------------------------------
    def _transcribe_words(self, audio_path: str) -> Optional[List[Dict]]:
        """Word timings via faster-whisper (CPU int8, ref :505-513); None
        when the optional dependency is missing or transcription fails."""
        try:
            from faster_whisper import WhisperModel  # optional dep
        except ImportError:
            return None
        try:
            model = WhisperModel(self.whisper_model, device="cpu", compute_type="int8")
            segments, _info = model.transcribe(audio_path, word_timestamps=True,
                                               language="en", beam_size=5)
            words = []
            for seg in segments:
                for w in (getattr(seg, "words", None) or []):
                    words.append({"word": w.word.strip(),
                                  "start": float(w.start), "end": float(w.end)})
            return words or None
        except Exception:
            return None

    @staticmethod
    def _clean_words(text: str) -> List[str]:
        """Normalize script text for transcript matching (ref :531-540)."""
        t = re.sub(r"Speaker\s+\d+:\s*", "", text)
        for a, b in (("’", "'"), ("‘", "'"), ("“", '"'),
                     ("”", '"'), ("—", "-"), ("–", "-"),
                     ("…", "...")):
            t = t.replace(a, b)
        return [w.strip(".,!?;:").lower() for w in t.split() if w.strip()]

    def _segments_from_words(self, chunks, words: List[Dict],
                             duration: float) -> List[CaptionSegment]:
        """Sequential forward-only matching of script chunks against
        transcribed word timings (ref :545-652): a 200-word search window,
        70% full / 50% partial match acceptance, apostrophe-tolerant
        comparison, proportional fallback, monotonicity enforcement."""
        transcribed = [w["word"].strip().lower() for w in words]
        out: List[CaptionSegment] = []
        word_idx = 0
        total_words = sum(_word_count(t) for _, t in chunks) or 1
        words_before = 0
        word_rate = self.wpm / 60.0

        for speaker, text in chunks:
            seg_words = self._clean_words(text)
            if not seg_words:
                continue
            # transcribed words are compared whitespace-stripped only (the
            # reference does not strip punctuation on the transcript side,
            # :556, :565) — script words carry the punctuation stripping
            seg_start = seg_end = None
            limit = min(word_idx + 200, len(transcribed))
            for i in range(word_idx, limit):
                if transcribed[i] != seg_words[0]:
                    continue
                # a failed (<50%) candidate is NOT reset: the reference keeps
                # the last candidate's start/end when the scan runs out
                matched = 1
                seg_start = words[i]["start"]
                seg_end = None
                look = min(i + len(seg_words) + 5, len(transcribed))
                for j in range(i + 1, look):
                    if matched >= len(seg_words):
                        break
                    nxt = transcribed[j]
                    exp = seg_words[matched]
                    if nxt == exp or nxt.replace("'", "") == exp.replace("'", ""):
                        matched += 1
                        seg_end = words[j]["end"]
                    elif matched >= len(seg_words) * 0.7:
                        break
                if matched >= len(seg_words) * 0.7:
                    word_idx = i + matched
                    break
                if matched >= len(seg_words) * 0.5:
                    if seg_end is None:
                        seg_end = words[min(i + matched - 1, len(words) - 1)]["end"]
                    word_idx = i + matched
                    break

            if seg_start is None:
                # proportional fallback (ref :594-618)
                seg_start = duration * words_before / total_words
                seg_end = seg_start + _word_count(text) / word_rate
                if out and seg_start < out[-1].end:
                    shift = out[-1].end - seg_start
                    seg_start += shift
                    seg_end += shift
            if seg_end is None:
                seg_end = seg_start + 1.0
            if out and seg_start < out[-1].end:  # monotonicity (ref :622-631)
                seg_start = out[-1].end
                if seg_end <= seg_start:
                    seg_end = seg_start + 1.0
            out.append(CaptionSegment(start=seg_start, end=min(seg_end, duration),
                                      text=text, speaker=speaker))
            words_before += _word_count(text)

        if out and duration > 0:
            out[-1].end = duration
        return out


# ---------------------------------------------------------------------------
# formatting (ref simple_caption_formatter.py:16-290)
# ---------------------------------------------------------------------------

def _ts_srt(t: float) -> str:
    h, rem = divmod(max(t, 0.0), 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{int(s):02d},{int(round((s % 1) * 1000)):03d}"


def _ts_vtt(t: float) -> str:
    h, rem = divmod(max(t, 0.0), 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{int(s):06.3f}"


class SimpleCaptionFormatter:
    def to_srt(self, segments: Sequence[CaptionSegment], include_speaker=True) -> str:
        out = []
        for i, seg in enumerate(segments, 1):
            text = f"{seg.speaker}: {seg.text}" if include_speaker and seg.speaker else seg.text
            out.append(f"{i}\n{_ts_srt(seg.start)} --> {_ts_srt(seg.end)}\n{text}\n")
        return "\n".join(out)

    def to_vtt(self, segments: Sequence[CaptionSegment], include_speaker=True) -> str:
        out = ["WEBVTT", ""]
        for seg in segments:
            text = f"<v {seg.speaker}>{seg.text}" if include_speaker and seg.speaker else seg.text
            out.append(f"{_ts_vtt(seg.start)} --> {_ts_vtt(seg.end)}\n{text}\n")
        return "\n".join(out)

    def to_json(self, segments: Sequence[CaptionSegment]) -> str:
        return json.dumps({"segments": [s.to_dict() for s in segments]}, indent=2)

    def to_transcript(self, segments: Sequence[CaptionSegment]) -> str:
        lines, cur_speaker, cur = [], None, []
        for seg in segments:
            if seg.speaker != cur_speaker and cur:
                lines.append(f"{cur_speaker}: {' '.join(cur)}")
                cur = []
            cur_speaker = seg.speaker
            cur.append(seg.text)
        if cur:
            lines.append(f"{cur_speaker}: {' '.join(cur)}")
        return "\n\n".join(lines)

    def to_script_timing(self, segments: Sequence[CaptionSegment]) -> str:
        return "\n".join(f"[{_ts_vtt(s.start)} - {_ts_vtt(s.end)}] {s.speaker}: {s.text}"
                         for s in segments)

    def create_caption_package(self, segments, output_dir: str, base_name: str,
                               include_speaker=True) -> Dict[str, str]:
        os.makedirs(output_dir, exist_ok=True)
        files = {}
        for ext, content in [
            ("srt", self.to_srt(segments, include_speaker)),
            ("vtt", self.to_vtt(segments, include_speaker)),
            ("json", self.to_json(segments)),
            ("txt", self.to_transcript(segments)),
            ("timing.txt", self.to_script_timing(segments)),
        ]:
            path = os.path.join(output_dir, f"{base_name}.{ext}")
            with open(path, "w", encoding="utf-8") as f:
                f.write(content)
            files[ext] = path
        return files


def split_long_segments(segments: Sequence[CaptionSegment], max_duration: float = 7.0,
                        max_words: int = 15) -> List[CaptionSegment]:
    """ref split_long_segments :1252."""
    out: List[CaptionSegment] = []
    for seg in segments:
        dur = seg.end - seg.start
        words = seg.text.split()
        if dur <= max_duration and len(words) <= max_words:
            out.append(seg)
            continue
        n = max(int(-(-dur // max_duration)), -(-len(words) // max_words))
        per = len(words) / n
        t = seg.start
        for i in range(n):
            chunk = words[int(i * per): int((i + 1) * per)]
            if not chunk:
                continue
            end = seg.start + dur * (i + 1) / n
            out.append(CaptionSegment(t, end, " ".join(chunk), seg.speaker))
            t = end
    return out


class FrameClockCaptionTracker:
    """Live captions driven by the engine's ACTUAL emitted-frame clock.

    The generated token stream carries real speech-segment boundaries — the
    model emits `speech_end` between speaker turns (the reference resets its
    tokenizer streaming caches there, modeling_vibevoice_inference.py:556-560)
    — and every emitted diffusion frame advances the audio position by
    exactly hop/sample_rate seconds.  Feeding the engine's per-step outputs
    (`generate(..., on_step=tracker.update)`) therefore gives exact per-turn
    caption timings: the streamed preview and the final caption package share
    one clock by construction, replacing the words-per-second estimate the
    round-2 demo used.

    If the model closes a different number of speech segments than the script
    has lines (e.g. merged turns), `segments()` returns None and the caller
    falls back to the WPM alignment ladder.
    """

    def __init__(self, script_lines: Sequence[Tuple[str, str]],
                 speech_end_id: int, hop: int, sample_rate: int = 24000,
                 sample_idx: int = 0):
        self.lines = list(script_lines)   # [(speaker, text)]
        self.speech_end_id = speech_end_id
        self.frame_sec = hop / float(sample_rate)
        self.sample_idx = sample_idx
        self.clock = 0.0                  # emitted audio seconds so far
        self.turn = 0                     # current script line index
        self.turn_start = 0.0
        self.bounds: List[Tuple[float, float]] = []  # closed turns

    def update(self, out) -> None:
        """Feed one engine StepOutput (numpy fields)."""
        if bool(out.emitted[self.sample_idx]):
            self.clock += self.frame_sec
        if int(out.token[self.sample_idx]) == self.speech_end_id \
                and self.turn < len(self.lines):
            self.bounds.append((self.turn_start, self.clock))
            self.turn_start = self.clock
            self.turn += 1

    @property
    def current(self) -> str:
        """The caption line active at the current emitted-audio position."""
        if not self.lines:
            return ""
        speaker, text = self.lines[min(self.turn, len(self.lines) - 1)]
        return f"{speaker}: {text}"

    def segments(self) -> Optional[List[CaptionSegment]]:
        """Exact engine-clock segments, or None if turn structure didn't
        match the script (caller falls back to the heuristic ladder)."""
        bounds = list(self.bounds)
        if self.turn == len(self.lines) - 1 and self.clock > self.turn_start:
            # final turn left open (generation ended at eos without a
            # trailing speech_end): close it at the current clock
            bounds.append((self.turn_start, self.clock))
        if len(bounds) != len(self.lines):
            return None
        return [CaptionSegment(start=s, end=e, text=text, speaker=speaker)
                for (s, e), (speaker, text) in zip(bounds, self.lines)]


__all__ = ["CaptionSegment", "SimpleCaptionGenerator", "SimpleCaptionFormatter",
           "FrameClockCaptionTracker",
           "split_sentences", "chunk_words", "split_long_segments"]
