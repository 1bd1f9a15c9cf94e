"""The port's training data pipeline against the JAX package's, array for
array, and one training step on a batch it built."""
import dataclasses

import numpy as np
import pytest
import torch

from vibevoice_tpu import data as JD
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import data as TD, train as TT
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import tokenizer as tok, vibevoice as TV
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer


def _examples(rng):
    """The examples of tests/test_data.py::test_build_batch_shapes_and_masks."""
    return [
        ([(1, " Hello there."), (2, " Hi.")],
         [rng.normal(0, 0.1, 40), rng.normal(0, 0.1, 16)]),
        ([(1, " Short.")], [rng.normal(0, 0.1, 20)]),
    ]


def _semantic_fn(speech):
    """A deterministic stand-in for the semantic encoder, [N, F, 16]."""
    f = speech.shape[1] // 16
    return np.cumsum(speech[:, : f * 16].reshape(len(speech), f, 16), axis=-1).astype(
        np.float32)


@pytest.mark.parametrize("semantic", [False, True])
@pytest.mark.parametrize("pad_to_multiple", [64, 32])
def test_build_training_batch_equals_jax(semantic, pad_to_multiple):
    kw = dict(hop=16, semantic_dim=16, pad_to_multiple=pad_to_multiple,
              semantic_fn=_semantic_fn if semantic else None)
    want = JD.build_training_batch(JTok(), _examples(np.random.default_rng(0)), **kw)
    got = TD.build_training_batch(ByteFallbackTokenizer(),
                                  _examples(np.random.default_rng(0)), **kw)
    assert type(got) is TT.TrainBatch and got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert isinstance(g, np.ndarray), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_build_training_example_equals_jax():
    rng = np.random.default_rng(3)
    turns = [(1, " One."), (2, " Two, three."), (1, " Four")]
    audio = [rng.normal(0, 0.1, n) for n in (3200, 3201, 9600)]
    want = JD.build_training_example(JTok(), turns, audio)
    got = TD.build_training_example(ByteFallbackTokenizer(), turns, audio)
    assert got[0] == want[0] and got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


def test_build_batch_shapes_and_masks():
    """tests/test_data.py's shape and mask checks, on the port."""
    tk = ByteFallbackTokenizer()
    batch = TD.build_training_batch(tk, _examples(np.random.default_rng(0)), hop=16,
                                    semantic_dim=16)
    b, t = batch.input_ids.shape
    assert b == 2 and t % 64 == 0
    assert batch.speech_masks.sum() == 6
    assert batch.acoustic_input_mask.sum() == 6
    np.testing.assert_array_equal(batch.acoustic_loss_mask[:, :-1],
                                  batch.acoustic_input_mask[:, 1:])
    for i in range(b):
        pos = np.nonzero(batch.acoustic_input_mask[i])[0]
        assert (batch.labels[i, pos - 1] == tk.speech_diffusion_id).all()


def test_batch_trains():
    """tests/test_data.py::test_batch_trains on the port: the semantic encoder
    fills the batch, and one train_step on the CPU gives finite losses."""
    cfg = tiny_config(vocab_size=320)
    tk = ByteFallbackTokenizer()
    hop = cfg.speech_compress_ratio
    rng = np.random.default_rng(1)
    params = TV.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params["speech_scaling_factor"] = torch.tensor(1.0)
    params["speech_bias_factor"] = torch.tensor(0.0)

    @torch.no_grad()
    def semantic_fn(speech):
        return tok.encoder_apply(params["semantic_encoder"], cfg.semantic_tokenizer,
                                 torch.from_numpy(speech)[..., None]).numpy()

    examples = [([(1, " A test.")], [rng.normal(0, 0.1, 2 * hop)])]
    batch = TD.build_training_batch(tk, examples, hop=hop, semantic_fn=semantic_fn,
                                    semantic_dim=cfg.semantic_vae_dim, pad_to_multiple=32)
    assert batch.speech_semantic_tensors.shape == (1, 2, cfg.semantic_vae_dim)

    opt = TT.make_optimizer(params, lr=1e-3, warmup_steps=0, total_steps=10)
    step = TT.make_train_step(cfg, opt, device="cpu")
    embed_before = params["lm"]["embed"].detach().clone()
    metrics = step(params, batch, torch.Generator().manual_seed(2))
    assert set(metrics) == {"loss", "ce_loss", "diffusion_loss"}
    assert all(m.dim() == 0 for m in metrics.values())
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["ce_loss"]) > 0
    assert not torch.equal(params["lm"]["embed"], embed_before)  # lr(0) > 0: no warm-up


def test_init_scaling_stats_sets_the_factors():
    cfg = tiny_config(vocab_size=320)
    cfg = dataclasses.replace(cfg, acoustic_tokenizer=dataclasses.replace(
        cfg.acoustic_tokenizer, fix_std=0.0))
    params = TV.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = TD.build_training_batch(ByteFallbackTokenizer(), _examples(
        np.random.default_rng(0)), hop=cfg.speech_compress_ratio, semantic_dim=16)
    out = TT.init_scaling_stats(params, cfg, None, batch, device="cpu")
    lat = tok.encoder_apply(params["acoustic_encoder"], cfg.acoustic_tokenizer,
                            torch.from_numpy(batch.speech_tensors)[..., None])
    m = torch.from_numpy(batch.speech_masks)
    sel = lat[m]
    assert out["speech_scaling_factor"].dtype == torch.float32
    torch.testing.assert_close(out["speech_bias_factor"], -sel.mean(), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(out["speech_scaling_factor"], 1 / sel.std(), rtol=1e-4,
                               atol=0)
    assert torch.isnan(params["speech_scaling_factor"])  # the input tree is unchanged


def test_train_step_reaches_no_kernel_wrapper(monkeypatch):
    """The port's kernels have no backward: a training step at T=1024 with
    head_dim 64 (where the engine would prefill through flash attention)
    calls none of the kernel wrappers, not even their plain CPU versions."""
    from vibevoice_tpu_torch.models import qwen2
    from vibevoice_tpu_torch.ops import (decode_attention as da, flash_attention as fa,
                                         fused_blocks as fb, fused_head as fh,
                                         fused_stage as fs, int4_matmul as im)
    from vibevoice_tpu_torch.utils import quantize

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called while training")

    for mod, name in ((da, "decode_attention"), (qwen2, "decode_attention"),
                      (fa, "flash_attention_prefill"), (qwen2, "flash_attention_prefill"),
                      (im, "int4_matmul"), (quantize, "int4_matmul"),
                      (fb, "fused_block_chain_batched"), (fb, "fused_block_chain_plain"),
                      (fb, "fused_block_chain"), (fh, "fused_head_solver_step"),
                      (fs, "fused_stage_chain"), (fs, "fused_stage_chain_rowlane")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    params = TV.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params["speech_scaling_factor"] = torch.tensor(1.0)
    params["speech_bias_factor"] = torch.tensor(0.0)
    batch = TD.build_training_batch(ByteFallbackTokenizer(), _examples(
        np.random.default_rng(0)), hop=cfg.speech_compress_ratio, semantic_dim=16,
        pad_to_multiple=1024)
    assert batch.input_ids.shape == (2, 1024) and cfg.decoder.head_dim == 64
    opt = TT.make_optimizer(params, lr=1e-3, warmup_steps=0, total_steps=10)
    metrics = TT.make_train_step(cfg, opt, device="cpu")(params, batch,
                                                         torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"]))
