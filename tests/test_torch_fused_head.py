"""The port's fused int4 diffusion-head step (`ops/fused_head.py`) against the
JAX package's, as tests/test_fused_head.py checks the JAX kernel: one solver
step (the JAX kernel in interpret mode on the CPU, the port's plain version),
and CFG sampling through `sample_speech_latents` with the pack in the tree."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.configs import DiffusionHeadConfig
from vibevoice_tpu.models import diffusion_head as jdh, vibevoice as JV
from vibevoice_tpu.ops import fused_head as JFH
from vibevoice_tpu.schedule import dpm_solver as jds
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import diffusion_head as tdh, vibevoice as TV
from vibevoice_tpu_torch.ops import fused_head as TFH
from vibevoice_tpu_torch.schedule import dpm_solver as tds
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests.test_torch_quantize import _assert_trees_equal


def _head(h, f, layers, lat, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"layers": [{"norm_w": 1 + 0.1 * r(h), "ada_w": 0.05 * r(h, 3 * h),
                        "gate": 0.03 * r(h, f), "up": 0.03 * r(h, f), "down": 0.03 * r(f, h)}
                       for _ in range(layers)],
            "noisy_proj": 0.05 * r(lat, h), "cond_proj": 0.05 * r(h, h),
            "t_mlp1": 0.05 * r(256, h), "t_mlp2": 0.05 * r(h, h),
            "final_ada_w": 0.05 * r(h, 2 * h), "final_linear": 0.05 * r(h, lat)}


@pytest.mark.parametrize("n", [2, 6])
def test_fused_head_step_matches_jax(n):
    h, f, layers, lat = 64, 192, 3, 16
    cfg = DiffusionHeadConfig(hidden_size=h, latent_size=lat, head_layers=layers,
                              head_ffn_ratio=3.0)
    head = _head(h, f, layers, lat, seed=n)
    jhead = {k: (jnp.asarray(v) if not isinstance(v, list) else
                 [{kk: jnp.asarray(vv) for kk, vv in lp.items()} for lp in v])
             for k, v in head.items()}
    thead = from_jax(head, device="cpu")
    jpack, tpack = JFH.pack_head_solver_q(jhead), TFH.pack_head_solver_q(thead)
    _assert_trees_equal(tpack, jpack)
    rng = np.random.default_rng(10 + n)
    cond = rng.normal(size=(n, h)).astype(np.float32)
    tsteps = np.array([3.0, 17.0], np.float32)
    jmods, jfin = jdh.precompute_modulations(jhead, cfg, jnp.asarray(cond), jnp.asarray(tsteps))
    tmods, tfin = tdh.precompute_modulations(thead, cfg, torch.tensor(cond),
                                             torch.tensor(tsteps))
    noisy = rng.normal(size=(n, lat)).astype(np.float32)
    for s in range(2):
        xp = noisy @ head["noisy_proj"]
        want = np.asarray(JFH.fused_head_solver_step(
            jpack, jnp.asarray(xp), jnp.stack([m[s] for m in jmods]), jfin[s],
            jhead["final_linear"], cfg.rms_norm_eps))
        got = TFH.fused_head_solver_step(
            tpack, torch.tensor(xp), torch.stack([m[s] for m in tmods]).contiguous(),
            tfin[s].contiguous(), thead["final_linear"], cfg.rms_norm_eps).numpy()
        assert got.shape == (n, lat)
        # fp32 on both sides with the same int4 weights: summation order only
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("algorithm,steps", [("sde-dpmsolver++", 5), ("dpmsolver++", 4)])
def test_sample_speech_latents_with_pack_matches_jax(algorithm, steps):
    """The pack in `params["_diffusion_head_packq"]` turns every solver step
    into one fused-head call, in both packages (CFG over [cond; neg])."""
    cfg, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    tcfg = TC.tiny_config(vocab_size=320)
    jp = dict(jp, _diffusion_head_packq=JFH.pack_head_solver_q(jp["diffusion_head"]))
    tp = dict(tp, _diffusion_head_packq=TFH.pack_head_solver_q(tp["diffusion_head"]))
    _assert_trees_equal(tp["_diffusion_head_packq"], jp["_diffusion_head_packq"])
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
    before = TFH.fused_head_solver_step.launches
    got = TV.sample_speech_latents(
        tp, tcfg, tsc, ts, torch.tensor(cond), torch.tensor(neg), 1.3, torch.tensor(x_init),
        step_noise=torch.tensor(step_noise)).numpy()
    assert TFH.fused_head_solver_step.launches == before  # the CPU takes the plain version
    # and the pack really replaced the plain head: its int4 weights move the result
    plain = TV.sample_speech_latents(
        dict(tp, _diffusion_head_packq=None), tcfg, tsc, ts, torch.tensor(cond),
        torch.tensor(neg), 1.3, torch.tensor(x_init), step_noise=torch.tensor(step_noise))
    assert np.abs(plain.numpy() - got).max() > 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_pack_rejects_quantized_heads():
    _, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    head = dict(tp["diffusion_head"])
    head["layers"] = [dict(lp, gateup=lp["gate"]) for lp in head["layers"]]
    with pytest.raises(ValueError, match="unquantized"):
        TFH.pack_head_solver_q(head)


# (H, F): the 1.5B head, the 7B head, the tiny one
_PLAN_SHAPES = [(1536, 4608), (3584, 10752), (64, 192)]


@pytest.mark.parametrize("n", [2, 8, 128])
@pytest.mark.parametrize("h,f", _PLAN_SHAPES)
def test_head_plan_invariants(h, f, n):
    """The head kernel's launch plan on an H100 (132 SMs, 15 clusters of 8):
    every F column owned by exactly one CTA in 8-column units (whole packed
    words, whole wd rows; the boxes cover them in 16-byte units), no more
    clusters than the card holds, shared memory within 227 KB, the rings
    within a layer's chunks (at least two stages where a layer has two), and
    row groups of at most 8 rows that cover N."""
    p = TFH.head_plan(n, h, f, 132, 15)
    assert p.tf % 8 == 0 and 8 <= p.tf and TFH.box_width(p.tf) <= 256
    assert all((k * p.tf) % 16 + p.tf <= TFH.box_width(p.tf) for k in range(p.tiles))
    owned = np.zeros(f, np.int64)
    for k in range(p.tiles):
        owned[k * p.tf:(k + 1) * p.tf] += 1
    assert (owned == 1).all()
    assert p.clusters == -(-p.tiles // TFH.CLUSTER) <= 15
    assert p.smem == TFH.head_smem(h, p.tf, p.rows, p.kb, p.ring, p.r2, p.ring2) <= 227 * 1024
    nk, n2 = h // 2 // p.kb, p.tf // 2 // p.r2
    assert p.kb <= 256 and nk * p.kb == h // 2 and min(2, nk) <= p.ring <= nk
    assert n2 * p.r2 == p.tf // 2 and min(2, n2) <= p.ring2 <= n2
    groups = -(-n // p.rows)
    assert 1 <= p.rows <= 8 and (groups - 1) * p.rows < n <= groups * p.rows


def test_head_plan_at_the_h100_shapes():
    """1.5B at N=2: 116 CTAs of 40 columns with a whole layer's slice in
    flight (gate/up in 3 boxes of 256 packed rows, wd in one run); N=8 in one
    row group; 7B: 112 CTAs of 96 columns, the slice streamed through
    two-stage rings; widths that are not 16-column units are refused."""
    p = TFH.head_plan(2, 1536, 4608, 132, 15)
    assert (p.tf, p.tiles, p.clusters, p.rows) == (40, 116, 15, 2)
    assert (p.kb, p.ring, p.r2, p.ring2) == (256, 3, 20, 1)
    assert TFH.head_plan(8, 1536, 4608, 132, 15).rows == 8
    p = TFH.head_plan(2, 3584, 10752, 132, 15)
    assert (p.tf, p.tiles, p.clusters) == (96, 112, 14)
    assert p.ring == 2 and p.ring2 >= 2 and 2 * p.kb * p.tf * p.ring < 3584 // 2 * p.tf * 2
    with pytest.raises(ValueError, match="multiples of 16"):
        TFH.head_plan(2, 1544, 4608, 132, 15)
