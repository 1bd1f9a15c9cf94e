"""The one traffic generator: inputs drawn from `--seed` by the parameters of
a traffic file (`traffic/<name>.json`).

A podcast batch (`kind` "podcast") is `batch` rows, each a prompt of
`speakers` voice prompts of `voice_frames` frames each (synthetic speech-like audio,
encoded by the acoustic encoder in the prefill) and script text, ending in
speech_start and left-padded to `prompt_len`, with each frame's x_T.  The row
lengths are the same set for every seed (`prompt_tokens` spread evenly over
the batch), in an order drawn from the seed, so that every seed does the same
work; token ids, voices and noise are drawn from the seed.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

SAMPLE_RATE = 24000


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of `seed` (weights, a batch's ids, noise...)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Batch(NamedTuple):
    ids: np.ndarray              # [B, P] int64, left-padded
    attention_mask: np.ndarray   # [B, P] int32
    speech_mask: np.ndarray      # [B, P] bool: the voice prompts' frame positions
    speech_tensors: torch.Tensor  # [B*speakers, samples] float32, rows in order
    frame_masks: np.ndarray      # [B*speakers, frames] bool
    latent_noise: torch.Tensor   # [max_steps, B, vae] x_T of each frame (served type)
    generator_seed: int          # the generator handed to the prefill (voice sampling)
    lengths: List[int]           # real tokens per row


def row_lengths(traffic: Dict, seed: int, index: int) -> List[int]:
    lo, hi = traffic["prompt_tokens"]
    b = traffic["batch"]
    base = [round(lo + (hi - lo) * i / max(1, b - 1)) for i in range(b)]
    perm = np.random.default_rng(sub_seed(seed, "lengths", index)).permutation(b)
    return [int(base[i]) for i in perm]


def voices(n: int, samples: int, seed: int, device) -> torch.Tensor:
    """`n` speech-like signals [n, samples] float32 on `device`: a harmonic
    source whose pitch wanders, gated into syllables, plus breath noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    r = torch.rand((n, 6), generator=gen, device=device)
    f0 = (90 + 160 * r[:, :1]) * (1 + 0.08 * torch.sin(2 * math.pi * (0.3 + r[:, 1:2]) * t))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / SAMPLE_RATE
    src = sum(torch.sin(k * phase) / k for k in range(1, 8))
    gate = 0.5 + 0.5 * torch.sin(2 * math.pi * (3 + 2 * r[:, 2:3]) * t + 6 * r[:, 3:4])
    noise = torch.randn((n, samples), generator=gen, device=device)
    return (0.15 * src * gate + 0.01 * noise) * (0.5 + r[:, 4:5])


def podcast_batch(traffic: Dict, ids: Dict, cfg, seed: int, index: int, device,
                  dtype) -> Batch:
    """Batch `index` of a podcast traffic, from `seed`."""
    b, spk, p_len = traffic["batch"], traffic["speakers"], traffic["prompt_len"]
    hop = cfg.speech_compress_ratio
    frames = traffic["voice_frames"]
    samples = frames * hop
    lengths = row_lengths(traffic, seed, index)
    if max(lengths) > p_len:
        raise ValueError(f"prompt of {max(lengths)} tokens over prompt_len {p_len}")
    rng = np.random.default_rng(sub_seed(seed, "ids", index))
    out_ids = np.full((b, p_len), ids["pad"], np.int64)
    att = np.zeros((b, p_len), np.int32)
    sim = np.zeros((b, p_len), bool)
    for r, n in enumerate(lengths):
        row, speech = [], []
        for _ in range(spk):  # "Speaker k:" text, then its voice prompt
            text = list(rng.integers(0, ids["text_max"], 4))
            seg = text + [ids["speech_start"]] + [ids["speech_diffusion"]] * frames \
                + [ids["speech_end"]]
            row += seg
            speech += [False] * 5 + [True] * frames + [False]
        fill = n - len(row) - 1
        if fill < 1:
            raise ValueError(f"a {n}-token prompt cannot hold {spk} voice prompts")
        row += list(rng.integers(0, ids["text_max"], fill)) + [ids["speech_start"]]
        speech += [False] * (fill + 1)
        out_ids[r, p_len - n:] = row
        att[r, p_len - n:] = 1
        sim[r, p_len - n:] = speech
    audio = voices(b * spk, samples, sub_seed(seed, "voices", index), device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "noise", index))
    noise = torch.randn((traffic["max_steps"], b, cfg.acoustic_vae_dim), generator=gen,
                        device=device).to(dtype)
    return Batch(out_ids, att, sim, audio, np.ones((b * spk, frames), bool), noise,
                 sub_seed(seed, "generator", index), lengths)


__all__ = ["SAMPLE_RATE", "sub_seed", "Batch", "row_lengths", "voices", "podcast_batch"]
