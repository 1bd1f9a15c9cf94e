"""The port's captions against the JAX package's on the same inputs: every rung
of `SimpleCaptionGenerator`'s alignment ladder (silences and transcribed
words fixed in both), the formatter's outputs and caption package, the
sentence utilities, `FrameClockCaptionTracker` fed the two engines' steps,
the whisper matchers and both caption processors."""
import dataclasses
import os

import numpy as np
import pytest

from vibevoice_tpu.caption import simple as JS
from vibevoice_tpu.caption import whisper as JW
from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.processor import captions_processor as JCP
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.caption import simple as TS
from vibevoice_tpu_torch.caption import whisper as TW
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.processor import captions_processor as TCP
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import END, tiny_params, to_np
from tests.test_torch_engine import GEN as ENGINE_GEN
from tests.test_torch_engine import STEPS as ENGINE_STEPS
from tests.test_torch_engine import _inputs as engine_inputs
from tests.test_torch_engine import _params as engine_params

LINES = [
    ("Speaker 1", "Welcome back to the show. Today we talk about voices!"),
    ("Speaker 2", "Thanks for having me. It is a pleasure to be here, truly."),
    ("Speaker 1", "Let us start with a long question that runs on and on for more than "
                  "fifteen words so that it must be chunked into two captions at least."),
    ("Speaker 3", "Short one?"),
    ("Speaker 2", "Yes. And another sentence. And a third, with a comma."),
]

SILENCES = {
    "match": [(2.1, 2.6), (4.0, 4.5), (6.2, 6.8), (8.0, 8.4), (9.9, 10.5), (12.0, 12.6),
              (14.1, 14.5), (15.9, 16.4)],
    "too_many": [(0.5, 0.6), (1.0, 1.4), (2.0, 2.3), (3.0, 3.9), (4.1, 4.2), (5.0, 5.6),
                 (6.0, 6.1), (7.0, 7.8), (8.0, 8.5), (9.0, 9.2), (10.0, 10.9), (11.5, 11.6),
                 (13.0, 13.7), (14.0, 14.3), (16.0, 16.5)],
    "too_few": [(3.0, 3.5), (9.0, 10.0)],
    "lead": [(0.0, 0.9), (5.0, 5.5), (12.0, 18.0)],
}


def _words(lines, skip=(), noise=()):
    """Transcribed words for `lines`, 0.3 s each: words at `skip` indices
    dropped, `noise` words inserted, punctuation kept on the transcript side."""
    out, t, i = [], 0.0, 0
    for _, text in lines:
        for w in text.split():
            if i not in skip:
                out.append({"word": w.strip(".,!?").capitalize() if i % 7 == 0 else w,
                            "start": t, "end": t + 0.25})
            if i in noise:
                out.append({"word": "uh", "start": t + 0.1, "end": t + 0.2})
            t += 0.3
            i += 1
    return out


WORDS = {"exact": _words(LINES), "gaps": _words(LINES, skip={3, 4, 20, 21, 22, 40}),
         "noisy": _words(LINES, noise={2, 9, 30}), "empty_tail": _words(LINES[:2])}


def _segs(segments):
    return [(s.start, s.end, s.text, s.speaker) for s in segments]


def _assert_same_segments(got, want, tol=1e-9):
    assert len(got) == len(want)
    for g, w in zip(_segs(got), _segs(want)):
        assert g[2:] == w[2:]
        assert abs(g[0] - w[0]) <= tol and abs(g[1] - w[1]) <= tol, (g, w)


def _both(**kw):
    return JS.SimpleCaptionGenerator(**kw), TS.SimpleCaptionGenerator(**kw)


@pytest.mark.parametrize("duration", [4.0, 17.5, 60.0, 300.0])
@pytest.mark.parametrize("lines", [LINES, LINES[:1], []], ids=["five", "one", "none"])
def test_wpm_rung_matches_jax(duration, lines):
    j, t = _both()
    _assert_same_segments(t.generate(lines, duration), j.generate(lines, duration))


@pytest.mark.parametrize("case", sorted(SILENCES))
@pytest.mark.parametrize("offset", [3.0, 0.0])
def test_silence_rung_matches_jax(monkeypatch, tmp_path, case, offset):
    """ffmpeg's silences fixed in both packages: the speech segments between
    them, the boundary selection and the word-count mapping."""
    audio = tmp_path / "a.wav"
    audio.write_bytes(b"RIFF")
    j, t = _both(silence_calibration_offset=offset)
    for g in (j, t):
        monkeypatch.setattr(g, "_transcribe_words", lambda p: None)
        monkeypatch.setattr(g, "_detect_silences", lambda p: list(SILENCES[case]))
    want = j.generate(LINES, 18.0, str(audio))
    got = t.generate(LINES, 18.0, str(audio))
    _assert_same_segments(got, want)
    assert _segs(want) != _segs(j.generate(LINES, 18.0))  # the WPM rung did not run
    for target in (1, 3, 11):
        assert (t.speech_segments_for_sentences(SILENCES[case], 18.0, target)
                == j.speech_segments_for_sentences(SILENCES[case], 18.0, target))


@pytest.mark.parametrize("case", sorted(WORDS))
def test_word_rung_matches_jax(monkeypatch, tmp_path, case):
    """faster-whisper's words fixed in both packages: the forward-only
    matcher with its partial matches, fallbacks and monotonicity."""
    audio = tmp_path / "a.wav"
    audio.write_bytes(b"RIFF")
    j, t = _both()
    for g in (j, t):
        monkeypatch.setattr(g, "_transcribe_words", lambda p: [dict(w) for w in WORDS[case]])
        monkeypatch.setattr(g, "_detect_silences", lambda p: pytest.fail("silence rung ran"))
    _assert_same_segments(t.generate(LINES, 25.0, str(audio)),
                          j.generate(LINES, 25.0, str(audio)))


def test_no_backends_fall_to_wpm(tmp_path):
    """With no whisper backend and no ffmpeg here, both ladders end on the
    WPM rung even with an audio file."""
    audio = tmp_path / "a.wav"
    audio.write_bytes(b"RIFF")
    j, t = _both()
    want = j.generate(LINES, 20.0)
    _assert_same_segments(t.generate(LINES, 20.0, str(audio)), want)
    _assert_same_segments(j.generate(LINES, 20.0, str(audio)), want)


def test_sentence_utilities_match_jax():
    texts = ["One. Two! Three? Four", "  ", "no punctuation at all", "A.B. c. d",
             " ".join(f"w{i}" for i in range(40))]
    for text in texts:
        assert TS.split_sentences(text) == JS.split_sentences(text)
        for n in (3, 15):
            assert TS.chunk_words(text, n) == JS.chunk_words(text, n)
    segs = [(0.0, 3.0, "short text", "Speaker 1"),
            (3.0, 20.0, " ".join(f"w{i}" for i in range(31)), "Speaker 2"),
            (20.0, 21.0, " ".join(f"v{i}" for i in range(16)), None)]
    for dur, words in ((7.0, 15), (2.5, 4)):
        got = TS.split_long_segments([TS.CaptionSegment(*s) for s in segs], dur, words)
        want = JS.split_long_segments([JS.CaptionSegment(*s) for s in segs], dur, words)
        _assert_same_segments(got, want, tol=0)


def _segments(mod):
    return [mod.CaptionSegment(0.0, 1.2345, "Hello there.", "Speaker 1"),
            mod.CaptionSegment(1.5, 61.0006, "Hi!", "Speaker 2"),
            mod.CaptionSegment(61.5, 3725.9995, "A long time later.", None),
            mod.CaptionSegment(3726.0, 3726.5, "Back again.", "Speaker 1")]


@pytest.mark.parametrize("include_speaker", [True, False])
def test_formatter_matches_jax_byte_for_byte(tmp_path, include_speaker):
    j, t = JS.SimpleCaptionFormatter(), TS.SimpleCaptionFormatter()
    js, ts = _segments(JS), _segments(TS)
    assert t.to_srt(ts, include_speaker) == j.to_srt(js, include_speaker)
    assert t.to_vtt(ts, include_speaker) == j.to_vtt(js, include_speaker)
    assert t.to_json(ts) == j.to_json(js)
    assert t.to_transcript(ts) == j.to_transcript(js)
    assert t.to_script_timing(ts) == j.to_script_timing(js)
    jf = j.create_caption_package(js, str(tmp_path / "jax"), "ep1", include_speaker)
    tf = t.create_caption_package(ts, str(tmp_path / "torch"), "ep1", include_speaker)
    assert sorted(tf) == sorted(jf) == ["json", "srt", "timing.txt", "txt", "vtt"]
    for k in jf:
        assert os.path.basename(tf[k]) == os.path.basename(jf[k])
        with open(tf[k], "rb") as a, open(jf[k], "rb") as b:
            assert a.read() == b.read(), k


# ---------------------------------------------------------------------------
# the frame clock, fed each package's engine steps
# ---------------------------------------------------------------------------

def _forced_engines():
    """(JAX engine, port engine) forced to diffuse every step, on the tiny
    weights and inputs of `tests/test_torch_engine.py`."""
    cfg, jp = tiny_params(0)
    gen = dict(ENGINE_GEN, force_diffusion=True)
    kw = dict(max_steps=ENGINE_STEPS, batch=2, prompt_len=24, inject_latent_noise=True)
    return (JG.Engine(jp, cfg, JG.GenerationConfig(**gen), **kw),
            TG.Engine(from_jax(to_np(jp), device="cpu"), TC.tiny_config(vocab_size=320),
                      TG.GenerationConfig(**gen), device="cpu", **kw))


def _turn_engines():
    """The same with `tests/test_torch_engine.py`'s subset LM head, whose rows
    cross speech_end and speech_start before EOS."""
    cfg, jp, tp = engine_params()
    kw = dict(max_steps=ENGINE_STEPS, batch=2, prompt_len=24, inject_latent_noise=True)
    return (JG.Engine(jp, cfg, JG.GenerationConfig(**ENGINE_GEN), **kw),
            TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**ENGINE_GEN),
                      device="cpu", **kw))


@pytest.mark.parametrize("turns", [False, True], ids=["forced", "turns"])
def test_frame_clock_tracker_matches_jax(turns):
    """Trackers of one and of three script lines on each row, fed through
    `generate(on_step=)` of each package's engine on the same weights,
    prompts and injected noise (dpmsolver++)."""
    ids, mask, sim, fmask, vl, noise = engine_inputs()
    hop = TC.tiny_config().speech_compress_ratio
    trackers = []
    for pkg, mod, eng in zip((JG, TG), (JS, TS), (_turn_engines if turns else _forced_engines)()):
        trs = [mod.FrameClockCaptionTracker(LINES[:n], speech_end_id=END, hop=hop,
                                            sample_idx=row) for n in (1, 3) for row in (0, 1)]
        pkg.generate(eng, ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                     latent_noise=noise, on_step=lambda o: [tr.update(o) for tr in trs])
        trackers.append(trs)
    for jt, tt in zip(*trackers):
        assert tt.clock == jt.clock > 0
        assert tt.bounds == jt.bounds and tt.turn == jt.turn and tt.current == jt.current
        js, ts = jt.segments(), tt.segments()
        assert (ts is None) == (js is None)
        if js is not None:
            _assert_same_segments(ts, js, tol=0)
        if turns:
            assert jt.bounds  # the engine closed at least one turn
        else:
            assert not jt.bounds  # forced diffusion never emits speech_end
            if len(jt.lines) == 1:
                assert js[0].end == jt.clock  # the open turn closed at the clock


# ---------------------------------------------------------------------------
# whisper: the pure matchers, and the ImportError path
# ---------------------------------------------------------------------------

SCRIPT = ("Speaker 1: Hello there, welcome to the show.\n\n"
          "speaker 2 :  thanks, glad to be here\n"
          "not a speaker line\n"
          "Speaker 3:\n"
          "SPEAKER 10: the quick brown fox")
TRANSCRIBED = [{"text": " Hello there welcome ", "start": 0.0, "end": 1.5},
               {"text": "glad to be here", "start": 1.5, "end": 2.5, "no_speech_prob": 0.2},
               {"text": "nothing in common", "start": 2.5, "end": 3.0},
               {"text": "", "start": 3.0, "end": 3.1},
               {"text": "quick brown fox jumps"}]


@pytest.mark.parametrize("mapping", [None, {1: "Alice", 2: "Bob"}])
def test_whisper_matchers_match_jax(mapping):
    jg, tg = JW.CaptionGenerator, TW.CaptionGenerator
    assert tg.parse_script_segments(SCRIPT) == jg.parse_script_segments(SCRIPT)
    segs = jg.parse_script_segments(SCRIPT)
    assert (tg.match_transcription_to_script(TRANSCRIBED, segs, mapping)
            == jg.match_transcription_to_script(TRANSCRIBED, segs, mapping))


def test_whisper_match_speakers_matches_jax():
    """`match_speakers` on generators made without `__init__` (no backend
    here), CaptionSegments in both packages."""
    lines = [("Speaker 1", "hello there welcome"), ("Speaker 2", "glad to be here")]
    out = []
    for w, s in ((JW, JS), (TW, TS)):
        g = w.CaptionGenerator.__new__(w.CaptionGenerator)
        segs = [s.CaptionSegment(0.0, 1.0, "Hello there"), s.CaptionSegment(1.0, 2.0, "be here"),
                s.CaptionSegment(2.0, 3.0, "unrelated words")]
        out.append(_segs(g.match_speakers(segs, lines)))
    assert out[1] == out[0]


def test_both_whisper_generators_raise_import_error():
    assert JW._backend() is None and TW._backend() is None
    with pytest.raises(ImportError):
        JW.CaptionGenerator()
    with pytest.raises(ImportError):
        TW.CaptionGenerator()
    with pytest.raises(ImportError):
        TW.CaptionGenerator("tiny", device="cpu")
    assert TW.CaptionFormatter is TS.SimpleCaptionFormatter


# ---------------------------------------------------------------------------
# the caption processors
# ---------------------------------------------------------------------------

PARSED = [(0, "Hello there. Welcome to the show."), (1, "Thanks!"), (0, "Let us begin.")]


@pytest.mark.parametrize("kind", ["simple", "whisper"])
def test_caption_processors_match_jax(tmp_path, kind):
    """Both processors write the same wav and caption package; the whisper
    one takes its script-timing fallback (no backend here)."""
    audio = np.random.default_rng(3).normal(0, 0.1, 24000 * 3).astype(np.float32)
    outs = []
    for name, mod, tok in (("jax", JCP, JTok), ("torch", TCP, TTok)):
        cls = (mod.VibeVoiceProcessorSimpleCaptions if kind == "simple"
               else mod.VibeVoiceProcessorWithCaptions)
        proc = cls(tok(), speech_tok_compress_ratio=3200)
        if kind == "simple":
            segs = proc.generate_captions_for_audio(PARSED, 3.0)
            outs.append(_segs(segs))
        d = tmp_path / name
        d.mkdir()
        files = proc.save_audio_with_captions(audio, str(d / "ep.wav"), PARSED)
        outs.append({k: open(v, "rb").read() for k, v in sorted(files.items())})
    if kind == "simple":
        assert outs[2] == outs[0]
        assert outs[3] == outs[1]
    else:
        assert outs[1] == outs[0]
    assert sorted(outs[-1]) == ["json", "srt", "timing.txt", "txt", "vtt", "wav"]


def test_whisper_processor_defaults_to_cuda():
    proc = TCP.VibeVoiceProcessorWithCaptions(TTok(), speech_tok_compress_ratio=3200)
    assert proc.whisper_device == "cuda"
    assert dataclasses.is_dataclass(TS.CaptionSegment)
