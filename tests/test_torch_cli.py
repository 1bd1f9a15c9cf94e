"""The port's CLIs (`vibevoice_tpu_torch/demo/`) against the JAX package's
(`demo/*.py`, `generate_captions_for_existing_audio.py`) on the CPU: each
run with `--tiny --device cpu` on the port's side, both packages' models
made from one tiny weight set, their engines forced to diffuse with the same
injected noise (dpmsolver++).  The wavs agree within the engine parity
tolerance, the caption files byte for byte, and the batch CLI's
`Saved audio to:` lines are the JAX CLI's."""
import dataclasses
import importlib.util
import os
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.pipeline import VibeVoiceTTS as JTTS
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS as TTTS
from vibevoice_tpu_torch.processor.audio import save_audio
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 6
NOISE = np.random.default_rng(11).normal(size=(MAX_NEW + 1, 2, 8)).astype(np.float32)
SCRIPTS = {
    "dialogue": "Speaker Alice: Hello there, and welcome.\nSpeaker Bob: Thanks! Glad to be "
                "here.\nSpeaker Alice: Let us begin with the news of the day.",
    "solo": "Speaker 1: A single voice reads one line aloud.",
    "plain": "A line with no speaker at all.\nSpeaker 1: Then one with a speaker.",
}
# the batch CLI hands each file to the processor as it is
BATCH_SCRIPTS = {
    "a_news": "Speaker 1: Today in the news, a short item.\nSpeaker 2: And the weather.",
    "b_solo": "Speaker 1: One voice, one line.",
    "c_long": "Speaker 1: A longer third script, so that the prompts of the first batch "
              "differ in length and one row is left-padded.",
}


_JAX_TTS = {}


def _jax_module(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(cfg):
    # the acoustic VAE at fix_std 0: a voice prompt's latent is its mean in
    # both packages, whose random streams differ
    return dataclasses.replace(cfg, acoustic_tokenizer=dataclasses.replace(
        cfg.acoustic_tokenizer, fix_std=0.0))


def _forced_engine(G, **extra):
    """`VibeVoiceTTS._engine` forced to diffuse, with injected x_T."""
    def engine(self, batch, prompt_len, max_steps):
        bucket = max(self.prompt_bucket,
                     -(-prompt_len // self.prompt_bucket) * self.prompt_bucket)
        key = (batch, bucket, max_steps)
        if key not in self._engines:
            gen = G.GenerationConfig(
                speech_start_id=self.tokenizer.speech_start_id,
                speech_end_id=self.tokenizer.speech_end_id,
                speech_diffusion_id=self.tokenizer.speech_diffusion_id,
                eos_id=self.tokenizer.eos_id, cfg_scale=self.cfg_scale,
                ddpm_steps=self.ddpm_steps, algorithm_type=self.algorithm_type,
                force_diffusion=True)
            self._engines[key] = G.Engine(
                self.params, self.cfg, gen, max_steps=max_steps, batch=batch,
                prompt_len=bucket, dtype=self.dtype, inject_latent_noise=True,
                **{k: getattr(self, v) for k, v in extra.items()})
        return self._engines[key]
    return engine


def _noise_generate(G):
    orig = G.generate

    def generate(eng, *a, **kw):
        return orig(eng, *a, latent_noise=NOISE[:, :eng.batch], **kw)
    return generate


@pytest.fixture()
def shared(monkeypatch, tmp_path):
    """Both packages' `from_random` made from one tiny weight set, their
    engines forced and fed the same noise; short voice presets (the tiny
    model's hop is 16 samples); the JAX demos' VoiceMapper pointed at them."""
    cfg_, jp = tiny_params(0)
    made = []

    def jax_random(cls, cfg=None, seed=0, dtype=None, **kw):
        made.append("jax")
        key = tuple(sorted(kw.items()))
        if key not in _JAX_TTS:  # one instance per setting: its engines compile once
            _JAX_TTS[key] = JTTS(jp, _cfg(cfg_), JTok(), dtype=jnp.float32, **kw)
        return _JAX_TTS[key]

    def torch_random(cls, cfg=None, seed=0, dtype=None, device="cuda", **kw):
        assert cfg == TC.tiny_config(vocab_size=320) and dtype == torch.float32
        made.append(("torch", str(device)))
        return TTTS(from_jax(to_np(jp), device=device),
                    _cfg(TC.tiny_config(vocab_size=320)), TTok(), dtype=torch.float32,
                    device=device, **kw)

    monkeypatch.setattr(JTTS, "from_random", classmethod(jax_random))
    monkeypatch.setattr(TTTS, "from_random", classmethod(torch_random))
    monkeypatch.setattr(JTTS, "_engine", _forced_engine(JG))
    monkeypatch.setattr(TTTS, "_engine", _forced_engine(TG, device="device"))
    monkeypatch.setattr(JG, "generate", _noise_generate(JG))
    monkeypatch.setattr(TG, "generate", _noise_generate(TG))

    voices = tmp_path / "voices"
    rng = np.random.default_rng(2)
    for i, name in enumerate(("en-Alice_woman", "en-Bob_man", "en-Carol_woman")):
        save_audio(rng.normal(0, 0.1, 160 + 48 * i).astype(np.float32),
                   str(voices / f"{name}.wav"))
    jdemo = _jax_module("demo.inference_from_file", "demo/inference_from_file.py")
    monkeypatch.setitem(sys.modules, "demo.inference_from_file", jdemo)
    orig_init = jdemo.VoiceMapper.__init__
    monkeypatch.setattr(jdemo.VoiceMapper, "__init__",
                        lambda self, voices_dir=None, extra_dirs=(): orig_init(
                            self, str(voices), ()))
    scripts = tmp_path / "scripts"
    scripts.mkdir()
    for name, text in SCRIPTS.items():
        (scripts / f"{name}.txt").write_text(text + "\n", encoding="utf-8")
    batch = tmp_path / "batch"
    batch.mkdir()
    for name, text in BATCH_SCRIPTS.items():
        (batch / f"{name}.txt").write_text(text, encoding="utf-8")
    return dict(voices=str(voices), scripts=scripts, batch=batch, made=made, tmp=tmp_path)


def _run_jax(monkeypatch, path, argv):
    monkeypatch.setattr(sys, "argv", [path, *argv])
    mod = sys.modules["demo.inference_from_file"]  # the one with the short voices
    if path != "demo/inference_from_file.py":
        mod = _jax_module("jax_cli", path)
    return mod.main()


def _pcm(path):
    with wave.open(str(path), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 24000)
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64) / 32767


def _same_wav(got, want):
    g, w = _pcm(got), _pcm(want)
    assert g.shape == w.shape and np.abs(w).max() > 1e-2
    # the engine parity tolerance (1e-4) and one PCM16 step
    np.testing.assert_allclose(g, w, atol=1e-4 + 1 / 32767, rtol=0)


def _same_captions(got_dir, want_dir, base):
    for ext in ("srt", "vtt", "json", "txt", "timing.txt"):
        with open(os.path.join(got_dir, f"{base}.{ext}"), "rb") as g, \
                open(os.path.join(want_dir, f"{base}.{ext}"), "rb") as w:
            assert g.read() == w.read(), ext


def test_inference_from_file_matches_jax(shared, monkeypatch):
    s, t = shared["scripts"], shared["tmp"]
    common = ["--txt_path", str(s / "dialogue.txt"), "--max_new_tokens", str(MAX_NEW),
              "--ddpm_steps", "3", "--seed", "5", "--tiny"]
    _run_jax(monkeypatch, "demo/inference_from_file.py", [*common, "--output_dir",
                                                          str(t / "jax")])
    from vibevoice_tpu_torch.demo import inference_from_file as T
    out = T.main([*common, "--output_dir", str(t / "torch"), "--device", "cpu",
                  "--voices_dir", shared["voices"]])
    assert shared["made"] == ["jax", ("torch", "cpu")]
    assert out["wav"] == str(t / "torch" / "dialogue_generated.wav")
    assert out["metrics"]["steps"] == MAX_NEW
    _same_wav(out["wav"], t / "jax" / "dialogue_generated.wav")


@pytest.mark.parametrize("cli", ["inference_simple_captions", "inference_with_captions"])
def test_caption_clis_match_jax(shared, monkeypatch, cli):
    """The two caption CLIs (the whisper one on its script-timing fallback,
    no backend here): the wav and every caption file."""
    s, t = shared["scripts"], shared["tmp"]
    common = ["--txt_path", str(s / "dialogue.txt"), "--max_new_tokens", str(MAX_NEW),
              "--ddpm_steps", "3"]
    _run_jax(monkeypatch, f"demo/{cli}.py", [*common, "--output_dir", str(t / "jax")])
    mod = importlib.import_module(f"vibevoice_tpu_torch.demo.{cli}")
    out = mod.main([*common, "--output_dir", str(t / "torch"), "--device", "cpu", "--tiny",
                    "--voices_dir", shared["voices"]])
    assert sorted(out["files"]) == ["json", "srt", "timing.txt", "txt", "vtt", "wav"]
    _same_wav(out["files"]["wav"], t / "jax" / "dialogue.wav")
    _same_captions(t / "torch", t / "jax", "dialogue")


def test_batch_cli_matches_jax(shared, monkeypatch, capsys):
    """Three scripts at --batch_size 2 (a batch of two, then one): each wav
    and caption package, and the `Saved audio to:` lines the shell pipelines
    grep, in order, byte for byte but for the output directory."""
    s, t = shared["batch"], shared["tmp"]
    common = ["--input_dir", str(s), "--batch_size", "2", "--max_new_tokens", str(MAX_NEW),
              "--ddpm_steps", "3", "--generate_captions", "--caption_formats", "srt",
              "--voices_dir", shared["voices"]]
    _run_jax(monkeypatch, "demo/batch_inference_simple_captions.py",
             [*common, "--output_dir", str(t / "jax")])
    jout = capsys.readouterr().out
    from vibevoice_tpu_torch.demo import batch_inference_simple_captions as T
    saved = T.main([*common, "--output_dir", str(t / "torch"), "--device", "cpu", "--tiny"])
    tout = capsys.readouterr().out
    lines = lambda out, d: [l.replace(str(t / d), "<out>") for l in out.splitlines()  # noqa: E731
                            if l.startswith("Saved audio to:")]
    assert lines(tout, "torch") == lines(jout, "jax") == [
        f"Saved audio to: <out>/{n}.wav" for n in sorted(BATCH_SCRIPTS)]
    assert tout.splitlines()[-3:] == [f"Saved audio to: {p}" for p in saved]
    for name in BATCH_SCRIPTS:
        _same_wav(t / "torch" / f"{name}.wav", t / "jax" / f"{name}.wav")
        _same_captions(t / "torch", t / "jax", name)


@pytest.mark.parametrize("whisper", [False, True])
def test_captions_for_existing_audio_match_jax(shared, monkeypatch, whisper):
    s, t = shared["scripts"], shared["tmp"]
    audio = np.random.default_rng(4).normal(0, 0.1, 24000 * 4).astype(np.float32)
    for d in ("jax", "torch"):
        save_audio(audio, str(t / d / "ep.wav"))
    common = ["--txt_path", str(s / "dialogue.txt")] + (["--use_whisper"] if whisper else [])
    _run_jax(monkeypatch, "generate_captions_for_existing_audio.py",
             [*common, "--audio_path", str(t / "jax" / "ep.wav")])
    from vibevoice_tpu_torch.demo import generate_captions_for_existing_audio as T
    files = T.main([*common, "--audio_path", str(t / "torch" / "ep.wav"), "--device", "cpu"])
    assert sorted(files) == ["json", "srt", "timing.txt", "txt", "vtt"]
    _same_captions(t / "torch", t / "jax", "ep")
