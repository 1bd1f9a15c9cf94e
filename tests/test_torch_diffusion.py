"""The port's diffusion path against the JAX package: solver tables (bit-equal),
solver trajectories for every algorithm and order, the diffusion head, the
connectors and CFG sampling with injected SDE noise."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.models import connectors as jconn, vibevoice as JV
from vibevoice_tpu.schedule import dpm_solver as jds
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import connectors as tconn, vibevoice as TV
from vibevoice_tpu_torch.schedule import dpm_solver as tds
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np

SCHEDULES = [
    ("cosine", {}, 5),
    ("linear", {"beta_schedule": "linear"}, 10),
    ("scaled_linear", {"beta_schedule": "scaled_linear"}, 7),
    ("zero_snr", {"rescale_betas_zero_snr": True, "timestep_spacing": "trailing"}, 6),
    ("karras", {"use_karras_sigmas": True}, 8),
    ("lu", {"use_lu_lambdas": True}, 8),
    ("leading", {"timestep_spacing": "leading", "steps_offset": 1}, 5),
    ("sigma_min", {"algorithm_type": "dpmsolver", "final_sigmas_type": "sigma_min"}, 5),
]


@pytest.mark.parametrize("name,kw,steps", SCHEDULES)
def test_schedule_tables_bit_equal(name, kw, steps):
    jc, tc = jds.SolverConfig(**kw), tds.SolverConfig(**kw)
    jt, tt = jds.make_tables(jc), tds.make_tables(tc)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    js, ts = jds.set_timesteps(jc, jt, steps), tds.set_timesteps(tc, tt, steps)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    np.testing.assert_array_equal(ts.sigmas, np.asarray(js.sigmas))
    assert ts.num_steps == js.num_steps


TRAJECTORIES = [
    ("dpmsolver++", 1, {}),
    ("dpmsolver++", 2, {}),
    ("dpmsolver++", 3, {}),
    ("dpmsolver++", 2, {"solver_type": "heun"}),
    ("dpmsolver++", 2, {"prediction_type": "epsilon"}),
    ("dpmsolver++", 2, {"thresholding": True, "sample_max_value": 1.5}),
    ("sde-dpmsolver++", 1, {}),
    ("sde-dpmsolver++", 2, {}),
    ("sde-dpmsolver++", 2, {"solver_type": "heun"}),
    ("dpmsolver", 1, {"final_sigmas_type": "sigma_min"}),
    ("dpmsolver", 2, {"final_sigmas_type": "sigma_min"}),
    ("dpmsolver", 3, {"final_sigmas_type": "sigma_min", "prediction_type": "sample"}),
    ("sde-dpmsolver", 2, {"final_sigmas_type": "sigma_min"}),
]


@pytest.mark.parametrize("algorithm,order,kw", TRAJECTORIES)
def test_solver_trajectory_matches_jax(algorithm, order, kw):
    """Identical pseudo model outputs and SDE noise through both steppers."""
    steps = 8
    jc = jds.SolverConfig(algorithm_type=algorithm, solver_order=order, **kw)
    tc = tds.SolverConfig(algorithm_type=algorithm, solver_order=order, **kw)
    js = jds.set_timesteps(jc, jds.make_tables(jc), steps)
    ts = tds.set_timesteps(tc, tds.make_tables(tc), steps)
    rng = np.random.default_rng(order)
    x0 = rng.normal(size=(3, 16)).astype(np.float32)
    outs = rng.normal(size=(steps, 3, 16)).astype(np.float32)
    noise = rng.normal(size=(steps, 3, 16)).astype(np.float32)
    jx, jst = jnp.asarray(x0), jds.init_state(jc, x0.shape)
    tx, tst = torch.tensor(x0), tds.init_state(tc, x0.shape)
    for i in range(steps):
        jx, jst = jds.step(jc, js, i, jst, jnp.asarray(outs[i]), jx, noise=jnp.asarray(noise[i]))
        tx, tst = tds.step(tc, ts, i, tst, torch.tensor(outs[i]), tx,
                           noise=torch.tensor(noise[i]))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    assert tst.lower_order_nums == int(jst.lower_order_nums)


def test_sde_third_order_rejected():
    with pytest.raises(NotImplementedError):
        tds.SolverConfig(algorithm_type="sde-dpmsolver++", solver_order=3)


def test_connector_matches_jax():
    cfg, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 3, cfg.acoustic_vae_dim)).astype(np.float32)
    want = np.asarray(jconn.apply(jp["acoustic_connector"], jnp.asarray(x)))
    got = tconn.apply(tp["acoustic_connector"], torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("algorithm,steps", [("sde-dpmsolver++", 5), ("dpmsolver++", 4)])
def test_sample_speech_latents_matches_jax(algorithm, steps):
    """CFG sampling through the diffusion head, with injected x_T and, for
    the SDE solver, injected per-step noise (`step_noise`); the production
    setting is sde-dpmsolver++ with 5 steps at cfg 1.3."""
    cfg, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    tcfg = TC.tiny_config(vocab_size=320)
    rng = np.random.default_rng(5)
    n, h, lat = 3, cfg.decoder.hidden_size, cfg.acoustic_vae_dim
    cond = rng.normal(size=(n, h)).astype(np.float32)
    neg = rng.normal(size=(n, h)).astype(np.float32)
    x_init = rng.normal(size=(n, lat)).astype(np.float32)
    step_noise = rng.normal(size=(steps, n, lat)).astype(np.float32)
    kw = dict(num_train_timesteps=cfg.diffusion_head.ddpm_num_steps,
              beta_schedule=cfg.diffusion_head.ddpm_beta_schedule,
              prediction_type=cfg.diffusion_head.prediction_type, algorithm_type=algorithm)
    jsc, tsc = jds.SolverConfig(**kw), tds.SolverConfig(**kw)
    js = jds.set_timesteps(jsc, jds.make_tables(jsc), steps)
    ts = tds.set_timesteps(tsc, tds.make_tables(tsc), steps)
    want = np.asarray(JV.sample_speech_latents(
        jp, cfg, jsc, js, jnp.asarray(cond), jnp.asarray(neg), 1.3, jnp.asarray(x_init),
        step_noise=jnp.asarray(step_noise)))
    got = TV.sample_speech_latents(
        tp, tcfg, tsc, ts, torch.tensor(cond), torch.tensor(neg), 1.3, torch.tensor(x_init),
        step_noise=torch.tensor(step_noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_lm_head_subset_and_splice_match_jax():
    cfg, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    ids = [260, 256, 258, 259]
    jsub = JV.lm_head_subset(jp, ids, jnp.float32)
    tsub = TV.lm_head_subset(tp, ids)
    h = np.random.default_rng(1).normal(size=(2, cfg.decoder.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(TV.lm_logits_subset(tsub, torch.tensor(h)).numpy(),
                               np.asarray(JV.lm_logits_subset(jsub, jnp.asarray(h))),
                               atol=1e-5, rtol=1e-5)
    emb = np.random.default_rng(2).normal(size=(2, 6, 4)).astype(np.float32)
    sp = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    mask = np.array([[0, 1, 1, 0, 0, 0], [0, 0, 0, 0, 1, 0]], bool)
    np.testing.assert_array_equal(
        TV.splice_speech_embeds(torch.tensor(emb), torch.tensor(sp), torch.tensor(mask)).numpy(),
        np.asarray(JV.splice_speech_embeds(jnp.asarray(emb), jnp.asarray(sp), jnp.asarray(mask))))
    lat = np.random.default_rng(4).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TV.unscale_latents(tp, TV.scale_latents(tp, torch.tensor(lat))).numpy(), lat, atol=1e-6)
    np.testing.assert_allclose(TV.scale_latents(tp, torch.tensor(lat)).numpy(),
                               np.asarray(JV.scale_latents(jp, jnp.asarray(lat))), atol=1e-6)
