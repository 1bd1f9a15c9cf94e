"""The port's training path against the JAX package: add_noise / get_velocity,
the per-row-timestep diffusion head, the speech scaling statistics,
training_forward's logits and losses, every parameter's gradient, and two
optimizer steps against the optax chain; the timestep samplers' draws.

Both sides get the same numpy weights (`tests._torch_parity.tiny_params`,
fp32) and the same injected noise and timesteps; the acoustic VAE samples
with `fix_std = 0`, so the voice latents are deterministic.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from vibevoice_tpu import data as JD, train as JT
from vibevoice_tpu.models import diffusion_head as jdh, vibevoice as JV
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer
from vibevoice_tpu.schedule import dpm_solver as jds
from vibevoice_tpu_torch import configs as TC, train as TT
from vibevoice_tpu_torch.models import diffusion_head as tdh, vibevoice as TV
from vibevoice_tpu_torch.schedule import dpm_solver as tds, timestep_sampler as tts
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np

# fp32 on both sides, sums in another order: a leaf agrees within this share
# of its largest magnitude (or of 1, for leaves smaller than 1)
REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (err, rel * scale)


def _cfgs():
    """(JAX cfg, port cfg): tiny_config(vocab_size=320), VAE fix_std 0."""
    jcfg, _ = tiny_params()
    tcfg = TC.tiny_config(vocab_size=320)
    fix = lambda c: dataclasses.replace(
        c, acoustic_tokenizer=dataclasses.replace(c.acoustic_tokenizer, fix_std=0.0))
    return fix(jcfg), fix(tcfg)


def _tables():
    jcfg, _ = _cfgs()
    dh = jcfg.diffusion_head
    return jds.make_tables(jds.SolverConfig(num_train_timesteps=dh.ddpm_num_steps,
                                            beta_schedule=dh.ddpm_beta_schedule,
                                            prediction_type=dh.prediction_type))


@functools.lru_cache(maxsize=None)
def _batch():
    """Two examples of three turns with clips of 3, 1 and 2 frames (hop 16):
    the shorter clips leave frames masked out by speech_masks."""
    rng = np.random.default_rng(0)
    examples = [
        ([(1, " Hello there."), (2, " Hi.")],
         [rng.normal(0, 0.1, 40), rng.normal(0, 0.1, 16)]),
        ([(1, " Short.")], [rng.normal(0, 0.1, 20)]),
    ]
    sem_rng = np.random.default_rng(1)
    sem_fn = lambda s: sem_rng.normal(0, 0.1, (s.shape[0], s.shape[1] // 16, 16)).astype(
        np.float32)
    return JD.build_training_batch(ByteFallbackTokenizer(), examples, hop=16,
                                   semantic_fn=sem_fn, semantic_dim=16)


def _injected(mul, seed=3):
    b = _batch()
    n = b.speech_masks.size * mul
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(n, 8)).astype(np.float32)
    t = rng.integers(0, 100, n).astype(np.int32)
    return noise, t


def _sli(use):
    if not use:
        return None
    m = np.ones(_batch().speech_masks.shape, bool)
    m[0, 1] = False
    return m


def _jax_forward(params, mul, sli, noise, t):
    jcfg, _ = _cfgs()
    b = _batch()
    return JV.training_forward(
        params, jcfg, _tables(), jax.random.PRNGKey(0),
        input_ids=jnp.asarray(b.input_ids), attention_mask=jnp.asarray(b.attention_mask),
        speech_tensors=jnp.asarray(b.speech_tensors), speech_masks=jnp.asarray(b.speech_masks),
        speech_semantic_tensors=jnp.asarray(b.speech_semantic_tensors),
        acoustic_input_mask=jnp.asarray(b.acoustic_input_mask),
        acoustic_loss_mask=jnp.asarray(b.acoustic_loss_mask),
        labels=jnp.asarray(b.labels), ddpm_batch_mul=mul,
        speeches_loss_input=None if sli is None else jnp.asarray(sli),
        injected_noise=jnp.asarray(noise), injected_timesteps=jnp.asarray(t))


def _torch_forward(params, mul, sli, noise, t):
    _, tcfg = _cfgs()
    b = TT._device_batch(_batch(), "cpu")
    return TV.training_forward(
        params, tcfg, TT.solver_tables(tcfg), None,
        input_ids=b.input_ids, attention_mask=b.attention_mask,
        speech_tensors=b.speech_tensors, speech_masks=b.speech_masks,
        speech_semantic_tensors=b.speech_semantic_tensors,
        acoustic_input_mask=b.acoustic_input_mask, acoustic_loss_mask=b.acoustic_loss_mask,
        labels=b.labels, ddpm_batch_mul=mul,
        speeches_loss_input=None if sli is None else torch.from_numpy(sli),
        injected_noise=torch.from_numpy(noise), injected_timesteps=torch.from_numpy(t))


def _port_params():
    _, jp = tiny_params()
    return from_jax(to_np(jp), device="cpu")


def test_add_noise_and_get_velocity_match_jax():
    tables = _tables()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 8)).astype(np.float32)
    noise = rng.normal(size=(12, 8)).astype(np.float32)
    t = rng.integers(0, 100, 12).astype(np.int32)
    for jf, tf in ((jds.add_noise, tds.add_noise), (jds.get_velocity, tds.get_velocity)):
        want = np.asarray(jf(tables, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)))
        got = tf(tables, torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_diffusion_head_apply_matches_jax():
    jcfg, tcfg = _cfgs()
    _, jp = tiny_params()
    tp = _port_params()
    rng = np.random.default_rng(1)
    n = 10
    noisy = rng.normal(size=(n, 8)).astype(np.float32)
    t = rng.integers(0, 100, n).astype(np.float32)
    cond = rng.normal(size=(n, 64)).astype(np.float32)
    want = jdh.apply(jp["diffusion_head"], jcfg.diffusion_head, jnp.asarray(noisy),
                     jnp.asarray(t), jnp.asarray(cond))
    got = tdh.apply(tp["diffusion_head"], tcfg.diffusion_head, torch.from_numpy(noisy),
                    torch.from_numpy(t), torch.from_numpy(cond))
    _close(got.numpy(), np.asarray(want))


def test_compute_scaling_stats_matches_jax():
    rng = np.random.default_rng(2)
    lat = rng.normal(0.3, 2.0, size=(3, 5, 8)).astype(np.float32)
    mask = np.ones((3, 5), bool)
    mask[1, 3:] = False
    mask[2, 1:] = False
    want = JV.compute_scaling_stats(jnp.asarray(lat), jnp.asarray(mask))
    got = TV.compute_scaling_stats(torch.from_numpy(lat), torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


@pytest.mark.parametrize("mul", [1, 4])
@pytest.mark.parametrize("use_sli", [False, True])
def test_training_forward_matches_jax(mul, use_sli):
    """Logits, CE and diffusion loss, with and without speeches_loss_input;
    the batch's masked frames (clips of 1 and 2 of 3 frames) included."""
    _, jp = tiny_params()
    noise, t = _injected(mul)
    sli = _sli(use_sli)
    assert not _batch().speech_masks.all()
    want = _jax_forward(jp, mul, sli, noise, t)
    got = _torch_forward(_port_params(), mul, sli, noise, t)
    _close(got.logits.detach().numpy(), np.asarray(want.logits))
    for name in ("ce_loss", "diffusion_loss"):
        g, w = float(getattr(got, name)), float(getattr(want, name))
        assert w > 0
        np.testing.assert_allclose(g, w, rtol=REL)


def _jax_loss(mul, sli, noise, t):
    def loss(params):
        out = _jax_forward(params, mul, sli, noise, t)
        return out.ce_loss + out.diffusion_loss
    return loss


@pytest.mark.parametrize("use_sli", [False, True])
def test_every_gradient_matches_jax(use_sli):
    """Each leaf's gradient against `jax.grad` of the same loss, in the JAX
    tree's flattening order (`train.trainable`); the leaves autograd leaves
    without a gradient (frozen tokenizers, and the semantic connector on the
    default path) are exactly zero in JAX."""
    mul = 4
    _, jp = tiny_params()
    noise, t = _injected(mul)
    sli = _sli(use_sli)
    jgrads = jax.tree_util.tree_leaves(jax.grad(_jax_loss(mul, sli, noise, t))(jp))
    tp = _port_params()
    leaves = TT.trainable(tp)
    assert [tuple(p.shape) for p in leaves] == [g.shape for g in jgrads]
    out = _torch_forward(tp, mul, sli, noise, t)
    (out.ce_loss + out.diffusion_loss).backward()
    n_none = 0
    for p, g in zip(leaves, jgrads):
        g = np.asarray(g)
        if p.grad is None:
            n_none += 1
            assert not g.any()
        else:
            _close(p.grad.numpy(), g)
    assert n_none > 0


@pytest.mark.parametrize("count", range(12))
def test_schedule_matches_optax(count):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)(count)
    np.testing.assert_allclose(TT.warmup_cosine_decay(count, 1e-2, 3, 10), float(want),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_global_norm_clip_matches_optax(scale):
    """Below the threshold the gradients stay bit-equal; above it they take
    optax's `g / norm * max_norm`."""
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,), ())]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = {"a": torch.zeros(3, 4), "b": torch.zeros(5), "c": torch.zeros(())}
    opt = TT.make_optimizer(params)
    for p, g in zip(opt.leaves, grads):
        p.grad = torch.from_numpy(np.array(g))
    norm = opt.clip_()
    np.testing.assert_allclose(float(norm), math.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                          for g in grads)), rtol=1e-6)
    for p, w, g in zip(opt.leaves, want, grads):
        if scale < 1:
            np.testing.assert_array_equal(p.grad.numpy(), g)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


def test_two_optimizer_steps_match_optax():
    """make_train_step over make_optimizer against the optax chain, composed
    here with training_forward, jax.value_and_grad and optimizer.update:
    step 1 has lr 0 (the parameters stay bit-equal), step 2 lr 1e-2.  The
    frozen tokenizers get zero gradients and only decay (x (1 - lr*wd))."""
    mul = 4
    _, jp = tiny_params()
    jopt = JT.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = jopt.init(jp)
    tp = _port_params()
    before = [p.clone() for p in TT.trainable(tp)]
    topt = TT.make_optimizer(tp, lr=1e-2, warmup_steps=1, total_steps=10)
    _, tcfg = _cfgs()
    step = TT.make_train_step(tcfg, topt, ddpm_batch_mul=mul, device="cpu")

    @jax.jit
    def jax_step(params, state, noise, t):
        loss, grads = jax.value_and_grad(_jax_loss(mul, None, noise, t))(params)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    for i in range(2):
        noise, t = _injected(mul, seed=10 + i)
        jp, jstate, jloss = jax_step(jp, jstate, noise, t)
        metrics = step(tp, _batch(), None, noise, t)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=REL)
        if i == 0:
            for p, b in zip(topt.leaves, before):
                assert torch.equal(p, b)
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(jleaves) == len(topt.leaves)
    for p, w in zip(topt.leaves, jleaves):
        _close(p.detach().numpy(), np.asarray(w))
    decay = np.float32(1 - 1e-2 * 0.01)
    enc_before = TT.trainable(
        {"e": from_jax(to_np(tiny_params()[1]["acoustic_encoder"]), device="cpu")})
    enc_after = TT.trainable({"e": tp["acoustic_encoder"]})
    for b, a in zip(enc_before, enc_after):
        if b.dim() > 1:
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy() * decay,
                                       rtol=1e-7, atol=0)
        else:
            assert torch.equal(a, b)


def test_trainable_lists_leaves_in_jax_order():
    _, jp = tiny_params()
    leaves = TT.trainable(_port_params())
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(leaves) == len(jleaves)
    for p, w in zip(leaves, jleaves):
        assert p.is_leaf and p.requires_grad
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w))


N_DRAWS = 20000


def test_uniform_sampler_distribution():
    t = tts.uniform_sample(torch.Generator().manual_seed(0), N_DRAWS, 1000)
    assert t.dtype == torch.int32 and t.shape == (N_DRAWS,)
    assert int(t.min()) >= 0 and int(t.max()) <= 999
    # mean of U{0..999} is 499.5, std 288.7: 5 standard errors is 10.2
    assert abs(float(t.double().mean()) - 499.5) < 10.2
    j = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (N_DRAWS,), 0, 1000))
    assert t.dtype == torch.int32 and j.dtype == np.int32


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (1.0, 0.5)])
def test_logit_normal_sampler_distribution(loc, scale):
    """sigmoid(N(loc, scale)) * T truncated: its mean against the same
    transform of a large numpy normal sample, and the JAX sampler's."""
    from vibevoice_tpu.schedule import timestep_sampler as jts
    t = tts.logit_normal_sample(torch.Generator().manual_seed(0), N_DRAWS, 1000, loc, scale)
    assert t.dtype == torch.int32 and t.shape == (N_DRAWS,)
    assert int(t.min()) >= 0 and int(t.max()) <= 999
    z = np.random.default_rng(0).normal(loc, scale, 10 ** 6)
    ref = np.clip((1000 / (1 + np.exp(-z))).astype(np.int32), 0, 999)
    # 5 standard errors of the port's sample mean
    bound = 5 * ref.std() / math.sqrt(N_DRAWS)
    assert abs(float(t.double().mean()) - ref.mean()) < bound
    j = np.asarray(jts.logit_normal_sample(jax.random.PRNGKey(0), N_DRAWS, 1000, loc, scale))
    assert j.dtype == np.int32 and abs(j.mean() - ref.mean()) < bound
