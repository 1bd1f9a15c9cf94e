"""The port's audio metrics (`utils/audio_metrics.py`, numpy float64 on the
host) against the JAX package's on seeded tones, noise and length mismatches,
and `models/norms.layer_norm` against the JAX one."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.models import norms as JN
from vibevoice_tpu.utils import audio_metrics as JA
from vibevoice_tpu_torch.models import norms as TN
from vibevoice_tpu_torch.utils import audio_metrics as TA

SR = 24000


def _tone(freq, n, phase=0.0, amp=0.3):
    t = np.arange(n) / SR
    return (amp * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)


def _pairs():
    rng = np.random.default_rng(0)
    a = _tone(220.0, 24000)
    yield "identical", a, a.copy()
    yield "noisy", a, a + rng.normal(0, 0.01, a.shape).astype(np.float32)
    yield "tones", a, _tone(330.0, 24000, 0.4)
    yield "white", rng.normal(0, 0.2, 12000), rng.normal(0, 0.2, 12000)
    yield "longer_test", a, np.concatenate([a, _tone(440.0, 5000)])
    yield "shorter_test", a, a[:17000] * 0.9
    yield "short_clip", a[:300], a[:300] * 1.1  # shorter than the reflect pad
    yield "silent_ref", np.zeros(8000, np.float32), a[:8000]


PAIRS = {name: (r, t) for name, r, t in _pairs()}


def _close(got, want):
    if np.isinf(want):
        assert got == want
    else:
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_compare_matches_jax(name):
    ref, test = PAIRS[name]
    got, want = TA.compare(ref, test), JA.compare(ref, test)
    assert sorted(got) == sorted(want) == ["len_ref_s", "len_test_s", "lsd_db", "mel_l2",
                                           "snr_db"]
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(24000, 1024, 80, None),
                                                  (16000, 512, 40, 7000.0)])
def test_spectral_pieces_match_jax(sr, n_fft, n_mels, fmax):
    np.testing.assert_array_equal(TA.mel_filterbank(sr, n_fft, n_mels, fmax=fmax),
                                  JA.mel_filterbank(sr, n_fft, n_mels, fmax=fmax))
    x = np.random.default_rng(1).normal(0, 0.1, 9000)
    np.testing.assert_array_equal(TA.stft_mag(x, n_fft, 256), JA.stft_mag(x, n_fft, 256))
    np.testing.assert_array_equal(TA.log_mel(x, sr, n_fft, 256, n_mels),
                                  JA.log_mel(x, sr, n_fft, 256, n_mels))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48)])
def test_layer_norm_fp32_matches_jax(shape):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    want = np.asarray(JN.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = TN.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_layer_norm_bf16_within_one_rounding_of_jax():
    """bf16 input and weights: the statistics and the affine step in fp32, one
    rounding back to bf16 at the end in both packages."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 6, 96)) * 2).astype(np.float32)
    w = rng.normal(size=(96,)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(JN.layer_norm(bf(x), bf(w), bf(b), 1e-6).astype(jnp.float32))
    tb = lambda a: torch.from_numpy(np.array(bf(a).astype(jnp.float32))).bfloat16()  # noqa: E731
    got = TN.layer_norm(tb(x), tb(w), tb(b), 1e-6)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 rounding step of each value: 2^-8 of its magnitude
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
