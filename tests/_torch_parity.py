"""Shared inputs for the PyTorch port's parity tests: one tiny fp32 model made
by the JAX package, handed to both packages as numpy."""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

import torch

from vibevoice_tpu.configs import tiny_config
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import vibevoice as TV

# ByteFallbackTokenizer control ids (a vocab of 320 covers them)
EOS, START, END, DIFF = 256, 258, 259, 260


def _boost(tree):
    """Lift the tokenizer's 1e-6 layer scales and 0.01 weights so the audio
    path carries signal of order 0.1 instead of 1e-7."""
    if isinstance(tree, dict):
        return {k: (v * 0.5e6 if k in ("gamma", "ffn_gamma")
                    else v * 10 if k == "w" else _boost(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_boost(v) for v in tree]
    return tree


@functools.lru_cache(maxsize=None)
def _tiny_np(seed: int):
    cfg = tiny_config(vocab_size=320)
    gen = torch.Generator().manual_seed(seed)
    p = TV.init_model(TC.tiny_config(vocab_size=320), generator=gen, device="cpu")
    p = jax.tree_util.tree_map(lambda t: t.numpy(), p)
    p["speech_scaling_factor"] = np.asarray(0.8, np.float32)
    p["speech_bias_factor"] = np.asarray(0.1, np.float32)
    for name in ("acoustic_decoder", "semantic_encoder", "acoustic_encoder"):
        p[name] = _boost(p[name])
    rng = np.random.default_rng(7)
    dh = p["diffusion_head"]
    for lp in dh["layers"]:
        lp["ada_w"] = rng.normal(size=lp["ada_w"].shape).astype(np.float32) * 0.05
    for k in ("final_ada_w", "final_linear"):
        dh[k] = rng.normal(size=dh[k].shape).astype(np.float32) * 0.05
    return cfg, p


def tiny_params(seed: int = 0):
    """(cfg, JAX params) of `tiny_config(vocab_size=320)` with a live audio
    path: boosted tokenizers, and random (not zero-initialized) adaLN and
    final layers in the diffusion head, so the LM hidden reaches the audio.
    The weights are drawn once as numpy (with the port's seeded init, which is
    cheap on the CPU) and handed to JAX as arrays."""
    cfg, p = _tiny_np(seed)
    return cfg, jax.tree_util.tree_map(jnp.asarray, p)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def spy_packs(monkeypatch):
    """The packs that the chain and stage wrappers are called with, by kind."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_stage as fs
    seen = {"chain": [], "stage": []}
    for mod, name, kind in ((fb, "fused_block_chain_plain", "chain"),
                            (fb, "fused_block_chain_batched", "chain"),
                            (fs, "fused_stage_chain", "stage")):
        real = getattr(mod, name)

        def spy(packed, *a, _real=real, _kind=kind, **k):
            seen[_kind].append(packed)
            return _real(packed, *a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen
