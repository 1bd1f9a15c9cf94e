"""DPM-Solver++ multistep scheduler, plain, as the cells run it.

The benchmark's frozen copy of the part of the port's `schedule/dpm_solver.py`
that the engine's settings reach (numerics of the reference's vendored
diffusers fork, `vibevoice/schedule/dpm_solver.py:122-1065`): `dpmsolver++`,
second order with the midpoint rule, first order at the first step and at the
last (`lower_order_final`, final sigma zero), `linspace` timestep spacing,
the cosine beta schedule and v-prediction.  The schedule tables are numpy in
both packages and computed by the same code, so they are bit-equal; the
per-step scalars are float32 numpy on the host and only the elementwise
update runs on the device, in float32 (ref :992-993).

A cell with another solver setting adds its branch here with the cell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SolverConfig:
    num_train_timesteps: int = 1000
    beta_schedule: str = "cosine"
    prediction_type: str = "v_prediction"
    algorithm_type: str = "dpmsolver++"

    def __post_init__(self):
        if (self.beta_schedule not in ("cosine", "squaredcos_cap_v2")
                or self.prediction_type != "v_prediction"
                or self.algorithm_type != "dpmsolver++"):
            raise NotImplementedError(
                f"the reference solver covers dpmsolver++ with a cosine schedule and "
                f"v-prediction, not {self}")


class SolverTables(NamedTuple):
    alphas_cumprod: np.ndarray  # [T] fp32
    sigmas_train: np.ndarray    # ((1-ac)/ac)**0.5


def make_tables(cfg: SolverConfig) -> SolverTables:
    """ref betas_for_alpha_bar :35-83 (cosine) and the cumulative products."""
    n = cfg.num_train_timesteps

    def ab(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = np.array([min(1 - ab((i + 1) / n) / ab(i / n), 0.999) for i in range(n)],
                     dtype=np.float32)
    # torch.cumprod accumulates in extended precision; f64 cumprod rounded to
    # f32 reproduces it bit-exactly (np's f32 cumprod does not)
    alphas_cumprod = np.cumprod((1.0 - betas).astype(np.float64)).astype(np.float32)
    sigmas_train = (((np.float32(1.0) - alphas_cumprod) / alphas_cumprod) ** 0.5).astype(np.float32)
    return SolverTables(alphas_cumprod, sigmas_train)


class Schedule(NamedTuple):
    """Inference-time schedule (host numpy; one entry per solver step)."""
    timesteps: np.ndarray  # [N] int32 train-timestep indices, descending
    sigmas: np.ndarray     # [N+1] fp32 sigma ladder, the last 0
    num_steps: int


def set_timesteps(cfg: SolverConfig, tables: SolverTables, num_inference_steps: int) -> Schedule:
    """ref set_timesteps :321-423 with linspace spacing."""
    timesteps = (np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps + 1)
                 .round()[::-1][:-1].copy().astype(np.int64))
    sigmas_full = np.asarray(tables.sigmas_train, dtype=np.float64)
    sigmas = np.interp(timesteps, np.arange(len(sigmas_full)), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return Schedule(timesteps=np.asarray(timesteps, np.int32), sigmas=sigmas,
                    num_steps=len(timesteps))


class SolverState(NamedTuple):
    """Solver history across the steps of one sampling trajectory."""
    history: torch.Tensor    # [2, *sample_shape] fp32 x0 predictions
    lower_order_nums: int


def init_state(cfg: SolverConfig, sample_shape: Tuple[int, ...], device="cpu") -> SolverState:
    return SolverState(history=torch.zeros((2,) + tuple(sample_shape), dtype=torch.float32,
                                           device=device), lower_order_nums=0)


_F = np.float32


def _alpha_sigma(sigma) -> Tuple[np.float32, np.float32]:
    sigma = _F(sigma)
    alpha_t = _F(1.0) / (sigma ** _F(2) + _F(1.0)) ** _F(0.5)
    return alpha_t, _F(sigma * alpha_t)


def _lam(sigma) -> np.float32:
    a, s = _alpha_sigma(sigma)
    with np.errstate(divide="ignore"):  # the final sigma 0 gives lambda = +inf
        return _F(np.log(a) - np.log(s))


def step(cfg: SolverConfig, sched: Schedule, i: int, state: SolverState,
         model_output: torch.Tensor, sample: torch.Tensor) -> Tuple[torch.Tensor, SolverState]:
    """Solver step `i` (ref step :935-1022, convert_model_output :528-625,
    the first- and second-order updates :627-817)."""
    alpha_s0, sigma_s0 = _alpha_sigma(sched.sigmas[i])
    x0 = float(alpha_s0) * sample.float() - float(sigma_s0) * model_output.float()
    history = torch.cat([state.history[1:], x0[None]], dim=0)
    alpha_t, sigma_t = _alpha_sigma(sched.sigmas[i + 1])
    lam_s0 = _lam(sched.sigmas[i])
    h = _F(_lam(sched.sigmas[i + 1]) - lam_s0)
    e = alpha_t * (np.exp(-h) - _F(1.0))
    prev = float(sigma_t / sigma_s0) * sample.float() - float(e) * x0
    final = i == sched.num_steps - 1
    if state.lower_order_nums >= 1 and not final:
        r0 = _F(_F(lam_s0 - _lam(sched.sigmas[i - 1])) / h)
        prev = prev - float(_F(0.5) * e) * (float(_F(1.0) / r0) * (x0 - history[-2]))
    new_lon = min(state.lower_order_nums + 1, 2)
    return prev.to(model_output.dtype), SolverState(history=history, lower_order_nums=new_lon)


__all__ = ["SolverConfig", "SolverTables", "make_tables", "Schedule", "set_timesteps",
           "SolverState", "init_state", "step"]
