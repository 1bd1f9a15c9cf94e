"""Host-side audio IO and normalization.

Behavioural port of `vibevoice/processor/vibevoice_tokenizer_processor.py`
(AudioNormalizer :19-87, load/save :100-483): dB-FS normalization to -25 dB
with clipping avoidance, 24 kHz mono load, wav save.  Pure numpy — this layer
never touches the device.  The PyTorch port's own copy of
`vibevoice_tpu/processor/audio.py`.
"""
from __future__ import annotations

import os
import struct
import wave
from typing import Optional

import numpy as np


class AudioNormalizer:
    """Normalize to a target dB FS then rescale to avoid clipping."""

    def __init__(self, target_dB_FS: float = -25, eps: float = 1e-6):
        self.target_dB_FS = target_dB_FS
        self.eps = eps

    def tailor_dB_FS(self, audio: np.ndarray):
        rms = np.sqrt(np.mean(audio ** 2))
        scalar = 10 ** (self.target_dB_FS / 20) / (rms + self.eps)
        return audio * scalar, rms, scalar

    def avoid_clipping(self, audio: np.ndarray):
        max_val = np.max(np.abs(audio))
        scalar = max_val + self.eps if max_val > 1.0 else 1.0
        return audio / scalar, scalar

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio, _, _ = self.tailor_dB_FS(audio)
        audio, _ = self.avoid_clipping(audio)
        return audio


def load_audio(path: str, sampling_rate: int = 24000) -> np.ndarray:
    """Load audio at the target rate, mono float32 in [-1, 1].

    Uses librosa/soundfile when available; falls back to the stdlib wave
    reader (16-bit PCM) with naive resampling.
    """
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    try:
        import librosa  # type: ignore
        wav, _ = librosa.load(path, sr=sampling_rate, mono=True)
        return wav.astype(np.float32)
    except Exception:
        pass
    try:
        import soundfile as sf  # type: ignore
        wav, sr = sf.read(path, dtype="float32")
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if sr != sampling_rate:
            wav = _resample_linear(wav, sr, sampling_rate)
        return wav.astype(np.float32)
    except Exception:
        pass
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        raw = w.readframes(n)
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        if ch > 1:
            data = data.reshape(-1, ch).mean(axis=1)
    if sr != sampling_rate:
        data = _resample_linear(data, sr, sampling_rate)
    return data.astype(np.float32)


def _resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wav
    n_out = int(round(len(wav) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(wav) - 1, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)


def save_audio(audio: np.ndarray, path: str, sampling_rate: int = 24000,
               normalize: bool = False) -> str:
    """Write mono float32 audio to a 16-bit PCM wav (ref save :352-457)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    wav = np.asarray(audio, np.float32).reshape(-1)
    if normalize and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    try:
        import soundfile as sf  # type: ignore
        sf.write(path, wav, sampling_rate)
        return path
    except Exception:
        pass
    pcm = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())
    return path


__all__ = ["AudioNormalizer", "load_audio", "save_audio"]
