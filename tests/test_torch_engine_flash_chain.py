"""The port's engine against the JAX engine on the two paths of the flash
prefill kernel (TPU kernel #5) and the plain-pack Block1D chain (#6), fed the
same tiny fp32 weights, prompts and diffusion noise (dpmsolver++ with
injected `latent_noise`; the JAX Pallas kernels in interpret mode on the
CPU): tokens and `emitted` exactly equal, audio within 1e-4 of its scale.

* flash prefill forced on (the tiny head_dim 16 is below the auto rule's
  1024-token / 128 bound), B=2 with one row left-padded, over a model-dtype
  and an int8 KV cache (flash attends the fresh k/v, not the dequantized
  cache, as the JAX engine does);
* `use_fused_vocoder` / `use_fused_semantic` with plain packs (built by each
  engine) at B=1 and B=2, and beside the large-T stage kernels
  (`use_fused_stages=True, fused_stage_t_min=7`);
* a JAX engine's plain packs carried through `weights.from_jax`."""
import numpy as np
import pytest
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import to_np
from tests.test_torch_engine import GEN, _params
from tests.test_torch_fused_stage import _assert_runs_match, _same_pack

BASE = dict(max_steps=16, prompt_len=24, inject_latent_noise=True)


def _pair(b, cfg, jp, tp, **kw):
    je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), batch=b, **BASE, **kw)
    te = TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN), batch=b,
                   device="cpu", **BASE, **kw)
    return je, te


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_flash_prefill_matches_jax(kv_dtype):
    """B=2, row 1 left-padded by 5 tokens, with the long-cache decode kernel
    path on as well."""
    je, te = _pair(2, *_params(), use_flash_prefill=True, use_flash_decode=True,
                   kv_dtype=kv_dtype)
    assert je.use_flash_prefill and te.use_flash_prefill
    _assert_runs_match(je, te, 2)


@pytest.mark.parametrize("b", [1, 2])
def test_engine_plain_chain_matches_jax(b):
    je, te = _pair(b, *_params(), use_fused_vocoder=True, use_fused_semantic=True)
    for key, want in (("_vocoder_packs", {0, 1, 2}), ("_semantic_packs", {1, 2, 3})):
        assert set(te.params[key]) == set(je.params[key]) == want
        for i in want:
            _same_pack(te.params[key][i], je.params[key][i], f"{key}/{i}")
    _assert_runs_match(je, te, b)


def test_engine_plain_chain_with_fused_stages_matches_jax():
    """The chain packs stay ahead of the large-T packs (the decoder's T = 8
    stage has both), as in the JAX engine."""
    je, te = _pair(1, *_params(), use_fused_vocoder=True, use_fused_semantic=True,
                   use_fused_stages=True, fused_stage_t_min=7)
    assert te.params["_vocoder_packs_large"] and te.params["_semantic_packs_large"]
    _assert_runs_match(je, te, 1)


def test_from_jax_carries_plain_chain_packs():
    """A JAX engine's plain chain packs carry over through `weights.from_jax`,
    equal the port's own and drive the port's engine to the JAX engine's
    tokens and audio."""
    cfg, jp, tp = _params()
    je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), batch=2, use_fused_vocoder=True,
                   use_fused_semantic=True, **BASE)
    carried = from_jax(to_np(je.params))
    own = TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN), batch=2,
                    device="cpu", use_fused_vocoder=True, use_fused_semantic=True, **BASE)
    for key in ("_vocoder_packs", "_semantic_packs"):
        assert set(carried[key]) == set(own.params[key]) and carried[key]
        for i in carried[key]:
            _same_pack(carried[key][i], own.params[key][i], f"{key}/{i}")
    te = TG.Engine(carried, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                   batch=2, device="cpu", use_fused_vocoder=True, use_fused_semantic=True,
                   **BASE)
    assert te.params["_vocoder_packs"] is not own.params["_vocoder_packs"]
    _assert_runs_match(je, te, 2)
