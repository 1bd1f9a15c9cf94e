"""The port's user-facing pipeline on the CPU: its processor against the JAX
package's, and a few requests served through `VibeVoiceTTS` with a streamer
and a stop check, the diffusion branch forced as in test_pipeline_smoke."""
import numpy as np
import pytest
import torch

from vibevoice_tpu.processor.processor import VibeVoiceProcessor as JProcessor
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.engine.streamer import AudioStreamer
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor as TProcessor
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok

SCRIPTS = [
    ("Speaker 1: Hello world.", 1),
    ("Speaker 1: Two voices.\nSpeaker 2: Yes, two of us.\nSpeaker 1: Good.", 2),
    ("Speaker 1: A third, longer request that runs on until it is stopped.", 1),
]


def _voices(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.05, 4800 + 1600 * i).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("script,n_voices", SCRIPTS)
def test_processor_matches_jax(script, n_voices):
    voices = _voices(n_voices)
    j = JProcessor(JTok(), speech_tok_compress_ratio=3200)(script, voices)
    t = TProcessor(TTok(), speech_tok_compress_ratio=3200)(script, voices)
    for name in ("input_ids", "attention_mask", "speech_input_mask", "speech_tensors",
                 "speech_masks"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                      np.asarray(getattr(j, name)), err_msg=name)


def force_diffusion_engine(tts, script, voices, max_new_tokens):
    """Register a force_diffusion engine under the key `generate` will ask for
    (with the pipeline's `use_fused_stages`, at the tiny model's T >= 7)."""
    t0 = tts.processor(script, voices).input_ids.shape[1]
    bucket = max(tts.prompt_bucket, -(-t0 // tts.prompt_bucket) * tts.prompt_bucket)
    gen = TG.GenerationConfig(
        speech_start_id=tts.tokenizer.speech_start_id,
        speech_end_id=tts.tokenizer.speech_end_id,
        speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
        eos_id=tts.tokenizer.eos_id, ddpm_steps=tts.ddpm_steps, force_diffusion=True,
        max_length_times=64.0, algorithm_type=tts.algorithm_type)
    chain = tts._chain_packs is not None
    tts._engines[(1, bucket, max_new_tokens)] = TG.Engine(
        tts.params, tts.cfg, gen, max_steps=max_new_tokens, batch=1, prompt_len=bucket,
        dtype=tts.dtype, device=tts.device, use_fused_vocoder=chain, use_fused_semantic=chain,
        use_fused_stages=tts.use_fused_stages, fused_stage_t_min=7)


def test_pipeline_serves_requests_with_streamer_and_stop():
    _serve(VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                    ddpm_steps=2, prompt_bucket=64, device="cpu",
                                    algorithm_type="sde-dpmsolver++"))


@pytest.mark.parametrize("modes", [
    dict(quantize="int4", quantize_tokenizer="int4k", quantize_diffusion="int4k"),
    dict(quantize="int4f", int4_group_size=16, quantize_tokenizer="int8", tokenizer_min_dim=4)])
def test_quantized_pipeline_serves_requests(modes):
    """Two quantized serving configurations through the same requests: the
    first with the int4 chain and head packs (its engines run the fused
    sigma-VAE stages), the second with int8 tokenizer FFNs."""
    tts = VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                   ddpm_steps=2, prompt_bucket=64, device="cpu",
                                   algorithm_type="sde-dpmsolver++", **modes)
    assert (tts._chain_packs is not None) == (modes.get("quantize_tokenizer") == "int4k")
    _serve(tts)


def _serve(tts):
    hop, stop_after, max_new = tts.cfg.speech_compress_ratio, 6, 16
    for script, n_voices in SCRIPTS:
        voices = _voices(n_voices)
        force_diffusion_engine(tts, script, voices, max_new)
        streamer = AudioStreamer(batch_size=1)
        seen = []
        res, metrics = tts.generate(script, voices, max_new_tokens=max_new,
                                    audio_streamer=streamer,
                                    stop_check_fn=lambda: len(seen) >= stop_after,
                                    on_step=seen.append)
        chunks = list(streamer.get_stream(0))
        # the stop check runs between 4-step chunks: 1 (prefill) + 4 + 4
        assert res.steps == len(seen) == 9
        assert len(chunks) == 9 and all(len(c) == hop for c in chunks)
        np.testing.assert_allclose(np.concatenate(chunks), res.audio[0], atol=0)
        assert np.isfinite(res.audio[0]).all() and np.abs(res.audio[0]).max() > 0
        assert metrics["audio_sec"] == 9 * hop / 24000.0


def test_pipeline_generate_takes_show_progress():
    """`VibeVoiceTTS.generate(show_progress=True)`, as the JAX pipeline and
    `demo/inference_from_file.py` call it: the same tokens and audio as
    without the bar."""
    tts = VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                   ddpm_steps=2, prompt_bucket=64, device="cpu")
    script, n_voices = SCRIPTS[0]
    voices = _voices(n_voices)
    force_diffusion_engine(tts, script, voices, 8)
    runs = [tts.generate(script, voices, max_new_tokens=8, show_progress=on)[0]
            for on in (False, True)]
    np.testing.assert_array_equal(runs[1].tokens, runs[0].tokens)
    assert runs[0].audio[0] is not None and np.isfinite(runs[0].audio[0]).all()
    np.testing.assert_array_equal(runs[1].audio[0], runs[0].audio[0])
