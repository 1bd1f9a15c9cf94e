"""The quantized serving modes as a whole: `VibeVoiceTTS(quantize=...,
quantize_tokenizer="int4k", quantize_diffusion="int4k")` built by the JAX
package and by the port from the same tiny fp32 weights, then the same
prompts and diffusion noise through both engines.

The quantized trees (int8/int4 values, scales and the chain/head packs) must be
bit-equal.  The engine runs the int4 GEMV, the int4 chain (both sigma-VAE
stacks) and the fused int4 head on every diffusion step; the subset LM head is
chosen so that both rows cross a speech_end and a later speech_start, as in
test_torch_engine."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.pipeline import VibeVoiceTTS as JTTS
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS as TTTS
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests.test_torch_engine import GEN, _crosses_end_then_start, _inputs, _run

B, T, STEPS = 2, 24, 16
# tokenizer_min_dim=4: the tiny stacks' unpacked stages take int8 FFNs too
COMMON = dict(quantize_tokenizer="int4k", quantize_diffusion="int4k", tokenizer_min_dim=4)
MODES = {"int8": dict(quantize="int8"), "int4": dict(quantize="int4"),
         "int4-gs16": dict(quantize="int4", int4_group_size=16),
         "int4f": dict(quantize="int4f")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype.name == "bfloat16" \
        else np.asarray(x)


def build(mode):
    cfg, jp = tiny_params(0)
    kw = dict(MODES[mode], **COMMON)
    jtts = JTTS(jp, cfg, JTok(), dtype=jnp.float32, **kw)
    ttts = TTTS(from_jax(to_np(jp)), TC.tiny_config(vocab_size=320), TTok(),
                dtype=torch.float32, device="cpu", **kw)
    return cfg, jtts, ttts


@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_pipeline_and_engine_match_jax(mode):
    cfg, jtts, ttts = build(mode)
    # the quantized trees: the same leaves, bit for bit
    jf, tf = _flat(jtts.params), _flat(ttts.params)
    assert sorted(jf) == sorted(tf)
    quantized = 0
    for k in jf:
        if jf[k] is None:
            assert tf[k] is None, k
            continue
        a, w = _np(tf[k]), _np(jf[k])
        assert a.dtype == w.dtype and a.shape == w.shape, k
        np.testing.assert_array_equal(a, w, err_msg=k)
        quantized += any(s in k for s in ("qint", "scale", "_packs", "_diffusion_head_packq"))
    assert quantized > 20
    assert set(ttts.params["_vocoder_packs"]) == {0, 1, 2}
    assert set(ttts.params["_semantic_packs"]) == {1, 2, 3}

    w = np.random.default_rng(24).normal(size=(cfg.decoder.hidden_size, 4)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 3] += 0.3
    kw = dict(max_steps=STEPS, batch=B, prompt_len=T, inject_latent_noise=True,
              use_fused_vocoder=True, use_fused_semantic=True)
    je = JG.Engine(dict(jtts.params, _lm_head_sub={"w": jnp.asarray(w)}), cfg,
                   JG.GenerationConfig(**GEN), **kw)
    te = TG.Engine(dict(ttts.params, _lm_head_sub={"w": torch.tensor(w)}),
                   TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                   device="cpu", **kw)
    args = _inputs()
    jr, (jtok, jchunk, jemit, jfin) = _run(JG, je, *args)
    tr, (ttok, tchunk, temit, tfin) = _run(TG, te, *args)

    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(temit, jemit)
    np.testing.assert_array_equal(tfin, jfin)
    assert tr.steps == jr.steps
    for r in range(B):
        assert _crosses_end_then_start(tr.tokens[r]), tr.tokens[r]
    # fp32 on both sides with the same int4/int8 weights; the differences are
    # summation order and the TPU chain kernel's rational erf (|err| < 1.5e-7)
    # against the exact erf, through 3 solver steps, both sigma-VAE stacks and
    # the re-encode: 1e-4 of the audio's scale
    scale = max(np.abs(a).max() for a in jr.audio if a is not None)
    assert scale > 1e-2
    np.testing.assert_allclose(tchunk, jchunk, atol=1e-4 * scale, rtol=0)
    for a, want in zip(tr.audio, jr.audio):
        np.testing.assert_allclose(a, want, atol=1e-4 * scale, rtol=0)
