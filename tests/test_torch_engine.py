"""The slice as a whole: the JAX engine and the port's engine on the long-cache
decode path (`use_flash_decode=True`, which in the port is the decode-attention
kernel's wrapper), fed the same tiny weights, prompts and diffusion noise.

Two left-padded prompts of different lengths, greedy selection, dpmsolver++
with injected `latent_noise`.  The subset LM head is chosen so that both rows
cross a speech_end (tokenizer state reset) and a later speech_start (reset of
the negative stream to its first entry) before they stop on EOS at different
steps; the test asserts that it does."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.models import vibevoice as TV
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import DIFF, END, EOS, START, tiny_params, to_np

B, T, STEPS = 2, 24, 16
GEN = dict(speech_start_id=START, speech_end_id=END, speech_diffusion_id=DIFF, eos_id=EOS,
           cfg_scale=1.5, ddpm_steps=3, max_length_times=16.0)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 250, (B, T)).astype(np.int32)
    ids[:, -1] = START
    mask = np.ones((B, T), np.int32)
    mask[1, :5] = 0  # row 1 is 5 tokens shorter, left-padded
    sim = np.zeros((B, T), bool)
    sim[0, 4:7] = True
    sim[1, 8:10] = True
    frame_masks = np.array([[1, 1, 1], [1, 1, 0]], bool)
    voice_latents = rng.normal(size=(B, 3, 8)).astype(np.float32)
    noise = rng.normal(size=(STEPS, B, 8)).astype(np.float32)
    return ids, mask, sim, frame_masks, voice_latents, noise


def _params():
    cfg, jp = tiny_params(0)
    # subset head over the sorted control ids [EOS, START, END, DIFF]
    w = np.random.default_rng(24).normal(size=(cfg.decoder.hidden_size, 4)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 3] += 0.3
    jp = dict(jp, _lm_head_sub={"w": jnp.asarray(w)})
    return cfg, jp, from_jax(to_np(jp))


def _run(package, engine, ids, mask, sim, fmask, vl, noise):
    steps = []
    res = package.generate(engine, ids, mask, sim, speech_frame_masks=fmask,
                           voice_latents=vl, latent_noise=noise,
                           on_step=lambda o: steps.append([np.asarray(x).copy() for x in o]))
    return res, [np.stack(x) for x in zip(*steps)]


def _crosses_end_then_start(row):
    row = list(row)
    i = row.index(DIFF)
    j = row.index(END, i)
    k = row.index(START, j)
    return DIFF in row[k:]


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_slice_matches_jax(kv_dtype):
    cfg, jp, tp = _params()
    args = _inputs()
    kw = dict(max_steps=STEPS, batch=B, prompt_len=T, inject_latent_noise=True,
              use_flash_decode=True, kv_dtype=kv_dtype)
    je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), **kw)
    te = TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                   device="cpu", **kw)
    assert te.cache_len == je.cache_len == 2048  # rounded up to 2048-slot multiples
    jr, (jtok, jchunk, jemit, jfin) = _run(JG, je, *args)
    tr, (ttok, tchunk, temit, tfin) = _run(TG, te, *args)

    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(temit, jemit)
    np.testing.assert_array_equal(tfin, jfin)
    np.testing.assert_array_equal(tr.reach_max, jr.reach_max)
    assert tr.steps == jr.steps
    for r in range(B):
        assert _crosses_end_then_start(tr.tokens[r]), tr.tokens[r]
        assert tr.tokens[r][-1] == EOS
    assert jfin[:, 0].sum() != jfin[:, 1].sum()  # the rows stop at different steps
    # fp32 everywhere; the differences are summation order through 3 solver
    # steps, the sigma-VAE decoder and the semantic re-encode
    np.testing.assert_allclose(tchunk, jchunk, atol=1e-4, rtol=0)
    for a, w in zip(tr.audio, jr.audio):
        assert w is not None and np.abs(w).max() > 1e-2
        np.testing.assert_allclose(a, w, atol=1e-4, rtol=0)


def test_engine_rejects_modes_outside_the_slice():
    """Meshes (ROADMAP A12) still raise; the auto rules of the JAX engine hold:
    flash prefill at prompts of 1024 tokens or more with head_dim % 128 == 0,
    flash decode at 4096 slots or more, with the cache rounded up to 2048-slot
    multiples (the engines are only built)."""
    cfg, _, tp = _params()
    tcfg = TC.tiny_config(vocab_size=320)
    gen = TG.GenerationConfig(**GEN)
    base = dict(max_steps=4, batch=1, prompt_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        TG.Engine(tp, tcfg, gen, **base, mesh=object())
    # head_dim 16 (tiny) and 128 (hidden 512, 4 heads): flash prefill auto-on
    # from 1024 prompt tokens, and only at a head_dim that is a multiple of 128
    wide = TC.tiny_config(hidden_size=512, vocab_size=320)
    wide_params = TV.init_model(wide, generator=torch.Generator().manual_seed(0))
    for c, p in ((tcfg, tp), (wide, wide_params)):
        for prompt_len in (1023, 1024):
            eng = TG.Engine(p, c, gen, max_steps=4, batch=1, prompt_len=prompt_len,
                            device="cpu")
            want = prompt_len >= 1024 and c.decoder.head_dim % 128 == 0
            assert eng.use_flash_prefill == want, (c.decoder.head_dim, prompt_len)
    assert TG.Engine(tp, tcfg, gen, **base, use_flash_prefill=True).use_flash_prefill
    # the auto flash-decode rule and its 2048-slot rounding, as in the JAX engine
    assert not TG.Engine(tp, tcfg, gen, **base).use_flash_decode
    eng = TG.Engine(tp, tcfg, gen, max_steps=3000, batch=1, prompt_len=1096, device="cpu")
    assert eng.use_flash_decode == (tcfg.decoder.head_dim % 128 == 0)
    on = TG.Engine(tp, tcfg, gen, max_steps=3000, batch=1, prompt_len=1096, device="cpu",
                   use_flash_decode=True)
    assert on.cache_len == 4096
    assert not torch.is_tensor(on.cache_len)


@pytest.mark.parametrize("variant", ["show_progress", "fused_stage_tile"])
def test_engine_takes_the_reference_arguments(variant):
    """`generate(show_progress=True)` (a tqdm bar) and `Engine(fused_stage_tile=…,
    fused_stage_tile_semantic=…)` (the JAX kernel's T tiles, ignored) are taken
    as the JAX engine takes them, and change neither tokens nor audio."""
    _, _, tp = _params()
    cfg, gen = TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN)
    ids, mask, sim, fmask, vl, noise = _inputs()
    kw = dict(max_steps=STEPS, batch=B, prompt_len=T, inject_latent_noise=True, device="cpu",
              use_fused_stages=True, fused_stage_t_min=7)
    tiles = dict(fused_stage_tile=200, fused_stage_tile_semantic=100)
    runs = []
    for on in (False, True):
        eng = TG.Engine(tp, cfg, gen, **kw, **(tiles if on and variant != "show_progress" else {}))
        runs.append(TG.generate(eng, ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                                latent_noise=noise,
                                show_progress=on and variant == "show_progress"))
    np.testing.assert_array_equal(runs[1].tokens, runs[0].tokens)
    assert runs[1].steps == runs[0].steps
    for a, w in zip(runs[1].audio, runs[0].audio):
        assert w is not None and np.isfinite(w).all()
        np.testing.assert_array_equal(a, w)
