"""Audio quality metrics (pure numpy, float64 — no librosa dependency).

The port's own copy of `vibevoice_tpu/utils/audio_metrics.py`, used by
`vibevoice_tpu_torch/scripts/quality_eval.py` to quantify quality deltas
between engine configurations (bf16 vs int8/int4 weights, solver/step
variants).  It runs on the host on numpy audio, so its numbers are the JAX
module's own.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular (Slaney-style, unnormalized) filters."""
    fmax = fmax or sr / 2.0
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz = _mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)))
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def stft_mag(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Magnitude spectrogram [frames, n_fft//2+1] (hann window, reflect pad)."""
    x = np.asarray(x, np.float64)
    pad = n_fft // 2
    x = np.pad(x, pad, mode="reflect") if len(x) >= pad + 1 else np.pad(x, pad)
    win = np.hanning(n_fft + 1)[:-1]
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.abs(np.fft.rfft(x[idx] * win[None, :], axis=-1))


def log_mel(x: np.ndarray, sr: int = 24000, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 80, eps: float = 1e-5) -> np.ndarray:
    """[frames, n_mels] log mel-power spectrogram."""
    mag = stft_mag(x, n_fft, hop)
    fb = mel_filterbank(sr, n_fft, n_mels)
    return np.log(np.maximum(mag ** 2 @ fb.T, eps))


def _align(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    return np.asarray(a[:n], np.float64), np.asarray(b[:n], np.float64)


def mel_spectral_distance(a: np.ndarray, b: np.ndarray, sr: int = 24000) -> float:
    """Mean L2 distance between log-mel frames (lower is better; 0 = identical)."""
    a, b = _align(a, b)
    ma, mb = log_mel(a, sr), log_mel(b, sr)
    n = min(len(ma), len(mb))
    return float(np.sqrt(((ma[:n] - mb[:n]) ** 2).sum(axis=-1)).mean())


def log_spectral_distance(a: np.ndarray, b: np.ndarray, sr: int = 24000) -> float:
    """Classic LSD in dB over linear-frequency power spectra."""
    a, b = _align(a, b)
    sa = 10 * np.log10(np.maximum(stft_mag(a) ** 2, 1e-10))
    sb = 10 * np.log10(np.maximum(stft_mag(b) ** 2, 1e-10))
    n = min(len(sa), len(sb))
    return float(np.sqrt(((sa[:n] - sb[:n]) ** 2).mean(axis=-1)).mean())


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Waveform SNR of `test` against `ref` (inf when identical)."""
    ref, test = _align(ref, test)
    err = ref - test
    p_sig = float((ref ** 2).sum())
    p_err = float((err ** 2).sum())
    if p_err == 0:
        return float("inf")
    return 10.0 * np.log10(max(p_sig, 1e-20) / p_err)


def compare(ref: np.ndarray, test: np.ndarray, sr: int = 24000) -> Dict[str, float]:
    return {
        "mel_l2": mel_spectral_distance(ref, test, sr),
        "lsd_db": log_spectral_distance(ref, test, sr),
        "snr_db": snr_db(ref, test),
        "len_ref_s": len(ref) / sr,
        "len_test_s": len(test) / sr,
    }


__all__ = ["log_mel", "mel_filterbank", "stft_mag", "mel_spectral_distance",
           "log_spectral_distance", "snr_db", "compare"]
