"""The port's causal convs and sigma-VAE tokenizers against the JAX package,
and streaming (one frame at a time) against full-T in both packages."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.models import tokenizer as jtok, vibevoice as JV
from vibevoice_tpu.ops import conv as jconv
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import tokenizer as ttok, vibevoice as TV
from vibevoice_tpu_torch.ops import conv as tconv
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("cin,cout,k,stride,groups,t", [
    (3, 5, 7, 1, 1, 20), (4, 6, 4, 2, 1, 17), (6, 6, 7, 1, 6, 13), (2, 3, 10, 5, 1, 25)])
def test_causal_conv1d_matches_jax(cin, cout, k, stride, groups, t):
    x = _rng(0).normal(size=(2, t, cin)).astype(np.float32)
    w = _rng(1).normal(size=(k, cin // groups, cout)).astype(np.float32)
    b = _rng(2).normal(size=(cout,)).astype(np.float32)
    want = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                          stride=stride, groups=groups))
    got = tconv.causal_conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                              stride=stride, groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride", [2, 4, 5])
def test_causal_conv_transpose1d_matches_jax(stride):
    x = _rng(3).normal(size=(2, 6, 4)).astype(np.float32)
    w = _rng(4).normal(size=(4, 2 * stride, 3)).astype(np.float32)
    b = _rng(5).normal(size=(3,)).astype(np.float32)
    want = np.asarray(jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                                    jnp.asarray(b), stride))
    got = tconv.causal_conv_transpose1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                                        stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride,chunk", [(1, 1), (2, 2), (2, 4), (4, 8)])
def test_conv_streaming_equals_full(stride, chunk):
    k = 7 if stride == 1 else 2 * stride
    x = _rng(6).normal(size=(2, 24, 3)).astype(np.float32)
    w = _rng(7).normal(size=(k, 3, 4)).astype(np.float32)
    b = _rng(8).normal(size=(4,)).astype(np.float32)
    full = tconv.causal_conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=stride)
    st = tconv.conv_state_init(2, 3, k, stride)
    parts = []
    for i in range(0, 24, chunk):
        y, st = tconv.causal_conv1d_streaming(torch.tensor(x[:, i:i + chunk]), st,
                                              torch.tensor(w), torch.tensor(b), stride=stride)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-5)
    # and the JAX package's streaming state carries the same context
    jst = jconv.conv_state_init(2, 3, k, stride)
    _, jst = jconv.causal_conv1d_streaming(jnp.asarray(x[:, :chunk]), jst, jnp.asarray(w),
                                           jnp.asarray(b), stride=stride)
    tst = tconv.conv_state_init(2, 3, k, stride)
    _, tst = tconv.causal_conv1d_streaming(torch.tensor(x[:, :chunk]), tst, torch.tensor(w),
                                           torch.tensor(b), stride=stride)
    np.testing.assert_array_equal(tst.buf.numpy(), np.asarray(jst.buf))


@pytest.mark.parametrize("stride,chunk", [(2, 1), (4, 3), (5, 2)])
def test_conv_transpose_streaming_equals_full(stride, chunk):
    """The carried overlap-add tail makes chunked output equal the full pass."""
    x = _rng(9).normal(size=(2, 12, 4)).astype(np.float32)
    w = _rng(10).normal(size=(4, 2 * stride, 3)).astype(np.float32)
    b = _rng(11).normal(size=(3,)).astype(np.float32)
    full = tconv.causal_conv_transpose1d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride)
    st = tconv.conv_transpose_state_init(2, 3, 2 * stride, stride)
    jst = jconv.conv_transpose_state_init(2, 3, 2 * stride, stride)
    parts = []
    for i in range(0, 12, chunk):
        y, st = tconv.causal_conv_transpose1d_streaming(torch.tensor(x[:, i:i + chunk]), st,
                                                        torch.tensor(w), torch.tensor(b), stride)
        jy, jst = jconv.causal_conv_transpose1d_streaming(jnp.asarray(x[:, i:i + chunk]), jst,
                                                          jnp.asarray(w), jnp.asarray(b), stride)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(st.tail.numpy(), np.asarray(jst.tail), atol=1e-5, rtol=1e-5)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def models():
    cfg, jp = tiny_params()
    return cfg, jp, from_jax(to_np(jp), device="cpu"), TC.tiny_config(vocab_size=320)


def test_encoder_and_decoder_match_jax(models):
    cfg, jp, tp, tcfg = models
    hop = cfg.speech_compress_ratio
    audio = _rng(12).normal(size=(2, 3 * hop, 1)).astype(np.float32) * 0.3
    want = np.asarray(jtok.encoder_apply(jp["semantic_encoder"], cfg.semantic_tokenizer,
                                         jnp.asarray(audio)))
    got = ttok.encoder_apply(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                             torch.tensor(audio)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    z = _rng(13).normal(size=(2, 3, cfg.acoustic_vae_dim)).astype(np.float32)
    want = np.asarray(jtok.decoder_apply(jp["acoustic_decoder"], cfg.acoustic_tokenizer,
                                         jnp.asarray(z)))
    got = ttok.decoder_apply(tp["acoustic_decoder"], tcfg.acoustic_tokenizer,
                             torch.tensor(z)).numpy()
    assert np.abs(want).max() > 1e-2  # the audio path carries signal
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_decoder_streaming_equals_full_in_both_packages(models):
    cfg, jp, tp, tcfg = models
    z = _rng(14).normal(size=(2, 4, cfg.acoustic_vae_dim)).astype(np.float32)
    full = ttok.decoder_apply(tp["acoustic_decoder"], tcfg.acoustic_tokenizer, torch.tensor(z))
    st = ttok.decoder_state_init(tcfg.acoustic_tokenizer, 2)
    jst = jtok.decoder_state_init(cfg.acoustic_tokenizer, 2)
    parts = []
    for f in range(4):
        y, st = ttok.decoder_apply_streaming(tp["acoustic_decoder"], tcfg.acoustic_tokenizer,
                                             torch.tensor(z[:, f:f + 1]), st)
        jy, jst = jtok.decoder_apply_streaming(jp["acoustic_decoder"], cfg.acoustic_tokenizer,
                                               jnp.asarray(z[:, f:f + 1]), jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-4, rtol=1e-4)


def test_encoder_streaming_equals_full_in_both_packages(models):
    cfg, jp, tp, tcfg = models
    hop = cfg.speech_compress_ratio
    audio = _rng(15).normal(size=(2, 4 * hop, 1)).astype(np.float32) * 0.3
    full = ttok.encoder_apply(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                              torch.tensor(audio))
    st = ttok.encoder_state_init(tcfg.semantic_tokenizer, 2)
    jst = jtok.encoder_state_init(cfg.semantic_tokenizer, 2)
    parts = []
    for f in range(4):
        chunk = audio[:, f * hop:(f + 1) * hop]
        y, st = ttok.encoder_apply_streaming(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                                             torch.tensor(chunk), st)
        jy, jst = jtok.encoder_apply_streaming(jp["semantic_encoder"], cfg.semantic_tokenizer,
                                               jnp.asarray(chunk), jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-4, rtol=1e-4)


def test_state_reset_where_matches_jax(models):
    cfg, _, _, tcfg = models
    jst = jtok.decoder_state_init(cfg.acoustic_tokenizer, 3)
    jst = [type(s)(*(jnp.ones_like(x) for x in s)) for s in jst]
    tst = [type(s)(*(torch.ones_like(x) for x in s))
           for s in ttok.decoder_state_init(tcfg.acoustic_tokenizer, 3)]
    mask = np.array([True, False, True])
    jr = jtok.state_reset_where(jst, jnp.asarray(mask))
    tr = ttok.state_reset_where(tst, torch.tensor(mask))
    assert [type(s).__name__ for s in tr] == [type(s).__name__ for s in jr]
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_encode_voice_prompts_matches_jax(models):
    """The encoder mean (noise off) matches; the gaussian sample is seeded by a
    torch.Generator and keeps the mean's shape."""
    import jax
    cfg, jp, tp, tcfg = models
    hop = cfg.speech_compress_ratio
    audio = _rng(16).normal(size=(2, 3 * hop)).astype(np.float32) * 0.3
    want = np.asarray(JV.encode_voice_prompts(jp, cfg, jax.random.PRNGKey(0),
                                              jnp.asarray(audio), sample_noise=False))
    got = TV.encode_voice_prompts(tp, tcfg, torch.tensor(audio), sample_noise=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    s1 = TV.encode_voice_prompts(tp, tcfg, torch.tensor(audio), generator=g1)
    s2 = TV.encode_voice_prompts(tp, tcfg, torch.tensor(audio), generator=g2)
    assert s1.shape == got.shape and torch.equal(s1, s2)
    assert not np.allclose(s1.numpy(), got)
