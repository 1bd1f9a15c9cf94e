"""DPM-Solver(++) multistep scheduler.

Port of `vibevoice_tpu/schedule/dpm_solver.py` (numerics of the reference's
vendored diffusers fork, `vibevoice/schedule/dpm_solver.py:122-1065`):

  * `SolverConfig`, `make_tables`, `set_timesteps` — the schedule tables are
    numpy in both packages and computed by the same code, so they are
    bit-equal;
  * `step` — one solver update.  The step index is a host int, so the
    per-step scalars (alpha, sigma, lambda, h) are computed on the host in
    float32 numpy and the order is chosen with plain Python `if`s; only the
    elementwise update runs on the device, in an fp32 island (ref :992-993).

Algorithms dpmsolver++ / sde-dpmsolver++ / dpmsolver / sde-dpmsolver, orders
1-3 (no sde third order, as in the reference), every timestep spacing, karras
/ lu sigmas, zero-SNR rescale and dynamic thresholding.  Training noises its
targets with `add_noise` and regresses `get_velocity`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_ALGORITHMS = ("dpmsolver++", "sde-dpmsolver++", "dpmsolver", "sde-dpmsolver")


@dataclass(frozen=True)
class SolverConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "cosine"          # linear | scaled_linear | cosine | squaredcos_cap_v2 | cauchy | laplace
    prediction_type: str = "v_prediction"  # epsilon | sample | v_prediction
    algorithm_type: str = "dpmsolver++"    # dpmsolver++ | sde-dpmsolver++ | dpmsolver | sde-dpmsolver
    solver_order: int = 2
    solver_type: str = "midpoint"
    lower_order_final: bool = True
    euler_at_final: bool = False
    final_sigmas_type: str = "zero"        # zero | sigma_min
    timestep_spacing: str = "linspace"     # linspace | leading | trailing
    steps_offset: int = 0
    lambda_min_clipped: float = -float("inf")
    use_karras_sigmas: bool = False
    use_lu_lambdas: bool = False
    rescale_betas_zero_snr: bool = False
    # pre-trained beta table (ref dpm_solver.py:139,209,232-233); a tuple so
    # the config stays hashable
    trained_betas: Optional[Tuple[float, ...]] = None
    # dynamic thresholding of the x0 prediction (ref :148-154,212-215,:425-457)
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0

    def __post_init__(self):
        if self.algorithm_type not in _ALGORITHMS:
            raise ValueError(f"unknown algorithm_type {self.algorithm_type}")
        if self.solver_order not in (1, 2, 3):
            raise ValueError("solver_order must be 1, 2 or 3")
        if self.solver_order == 3 and self.algorithm_type.startswith("sde"):
            # the reference implements no sde third-order update (:819-933
            # covers dpmsolver++/dpmsolver only)
            raise NotImplementedError("third order is not defined for sde solvers")
        if self.use_karras_sigmas and self.use_lu_lambdas:
            raise ValueError("choose at most one of karras / lu sigma schedules")
        if self.algorithm_type in ("dpmsolver", "sde-dpmsolver") and self.final_sigmas_type == "zero":
            # noise-prediction solvers divide by sigma; a zero final sigma is
            # rejected by the reference too (ref :280-284)
            raise ValueError(
                f"final_sigmas_type 'zero' is not supported for {self.algorithm_type}; "
                "use 'sigma_min'")

    @property
    def data_prediction(self) -> bool:
        return self.algorithm_type in ("dpmsolver++", "sde-dpmsolver++")

    @property
    def is_sde(self) -> bool:
        return self.algorithm_type.startswith("sde")


def _betas_for_alpha_bar(n: int, kind: str, max_beta: float = 0.999) -> np.ndarray:
    """ref betas_for_alpha_bar :35-83."""
    if kind == "cosine":
        def ab(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    elif kind == "exp":
        def ab(t):
            return math.exp(t * -12.0)
    elif kind == "cauchy":
        def ab(t, gamma=1, mu=3):
            snr = mu + gamma * math.tan(math.pi * (0.5 - t) * 0.9)
            return 1 - 1 / (math.exp(snr) + 1.1)
    elif kind == "laplace":
        def ab(t, mu=0, b=1):
            snr = mu - b * math.copysign(1, 0.5 - t) * math.log(1 - 2 * abs(t - 0.5) * 0.98)
            return 1 - 1 / (math.exp(snr) + 1.02)
    else:
        raise ValueError(kind)
    betas = [min(1 - ab((i + 1) / n) / ab(i / n), max_beta) for i in range(n)]
    return np.array(betas, dtype=np.float32)


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """ref rescale_zero_terminal_snr :87-120 (arXiv 2305.08891 alg. 1).

    Shifts sqrt(alphas_cumprod) so the terminal value is exactly zero, then
    rescales so the first value is unchanged; betas are recovered from the
    adjusted cumprod.  Math in float64, rounded to fp32 like torch fp32 ops.
    """
    alphas = 1.0 - betas.astype(np.float64)
    ac = np.cumprod(alphas)
    abs_sqrt = np.sqrt(ac)
    a0, aT = abs_sqrt[0], abs_sqrt[-1]
    abs_sqrt = (abs_sqrt - aT) * (a0 / (a0 - aT))
    ab = abs_sqrt ** 2
    alphas = np.concatenate([ab[:1], ab[1:] / ab[:-1]])
    return (1.0 - alphas).astype(np.float32)


class SolverTables(NamedTuple):
    alphas_cumprod: np.ndarray  # [T] fp32
    alpha_t: np.ndarray         # sqrt(alphas_cumprod)
    sigma_t: np.ndarray         # sqrt(1 - alphas_cumprod)
    lambda_t: np.ndarray        # log(alpha) - log(sigma)
    sigmas_train: np.ndarray    # ((1-ac)/ac)**0.5


def make_tables(cfg: SolverConfig) -> SolverTables:
    n = cfg.num_train_timesteps
    if cfg.trained_betas is not None:
        betas = np.asarray(cfg.trained_betas, dtype=np.float32)
        if betas.shape != (n,):
            raise ValueError(
                f"trained_betas must have length num_train_timesteps={n}, "
                f"got {betas.shape}")
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float32)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n, dtype=np.float32) ** 2
    elif cfg.beta_schedule in ("cosine", "squaredcos_cap_v2"):
        betas = _betas_for_alpha_bar(n, "cosine")
    elif cfg.beta_schedule in ("cauchy", "laplace"):
        betas = _betas_for_alpha_bar(n, cfg.beta_schedule)
    else:
        raise NotImplementedError(cfg.beta_schedule)
    if cfg.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    # torch.cumprod accumulates in extended precision; f64 cumprod rounded to
    # f32 reproduces it bit-exactly (np's f32 cumprod does not)
    alphas_cumprod = np.cumprod((1.0 - betas).astype(np.float64)).astype(np.float32)
    if cfg.rescale_betas_zero_snr:
        # "close to 0 without being 0 so first sigma is not inf" (ref :255-258)
        alphas_cumprod[-1] = 2.0 ** -24
    alpha_t = np.sqrt(alphas_cumprod).astype(np.float32)
    sigma_t = np.sqrt(np.float32(1.0) - alphas_cumprod).astype(np.float32)
    lambda_t = (np.log(alpha_t) - np.log(sigma_t)).astype(np.float32)
    sigmas_train = (((np.float32(1.0) - alphas_cumprod) / alphas_cumprod) ** 0.5).astype(np.float32)
    return SolverTables(alphas_cumprod, alpha_t, sigma_t, lambda_t, sigmas_train)



class Schedule(NamedTuple):
    """Inference-time schedule (host numpy; one entry per solver step)."""
    timesteps: np.ndarray  # [N] int32 train-timestep indices, descending
    sigmas: np.ndarray     # [N+1] fp32 sigma ladder (last entry 0 for 'zero')
    num_steps: int


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Fractional train-timestep for each sigma by piecewise-log-linear
    inversion of the training sigma table (ref _sigma_to_t :441-463)."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, np.newaxis]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return ((1 - w) * low_idx + w * high_idx).reshape(sigma.shape)


def set_timesteps(cfg: SolverConfig, tables: SolverTables, num_inference_steps: int) -> Schedule:
    """ref set_timesteps :321-423."""
    if math.isinf(cfg.lambda_min_clipped):
        last_timestep = cfg.num_train_timesteps
    else:
        flipped = tables.lambda_t[::-1]
        clipped_idx = int(np.searchsorted(flipped, cfg.lambda_min_clipped))
        last_timestep = cfg.num_train_timesteps - clipped_idx

    if cfg.timestep_spacing == "linspace":
        timesteps = (
            np.linspace(0, last_timestep - 1, num_inference_steps + 1)
            .round()[::-1][:-1].copy().astype(np.int64)
        )
    elif cfg.timestep_spacing == "leading":
        step_ratio = last_timestep // (num_inference_steps + 1)
        timesteps = (
            (np.arange(0, num_inference_steps + 1) * step_ratio)
            .round()[::-1][:-1].copy().astype(np.int64)
        )
        timesteps += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = cfg.num_train_timesteps / num_inference_steps
        timesteps = np.arange(last_timestep, 0, -step_ratio).round().astype(np.int64) - 1
    else:
        raise NotImplementedError(cfg.timestep_spacing)

    sigmas_full = np.asarray(tables.sigmas_train, dtype=np.float64)
    # the reference takes log in float32 (np.log of the fp32 sigma table);
    # mirroring that keeps _sigma_to_t's rounding decisions identical
    log_sigmas = np.log(np.asarray(tables.sigmas_train, dtype=np.float32))
    if cfg.use_karras_sigmas:
        # Karras et al. (2022) rho-7 ramp between the training range extremes
        # (ref _convert_to_karras :490-510)
        in_sigmas = np.flip(np.asarray(tables.sigmas_train, dtype=np.float32))
        sigma_min, sigma_max = float(in_sigmas[-1]), float(in_sigmas[0])
        rho = 7.0
        ramp = np.linspace(0, 1, num_inference_steps)
        sigmas = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
        timesteps = _sigma_to_t(sigmas, log_sigmas).round()
    elif cfg.use_lu_lambdas:
        # Lu et al. (2022) uniform-log-sigma ramp (ref _convert_to_lu :512-524;
        # rho=1 so the ramp is linear in log sigma)
        in_lambdas = np.flip(log_sigmas)
        lmin, lmax = float(in_lambdas[-1]), float(in_lambdas[0])
        lambdas = lmax + np.linspace(0, 1, num_inference_steps) * (lmin - lmax)
        sigmas = np.exp(lambdas)
        timesteps = _sigma_to_t(sigmas, log_sigmas).round()
    else:
        sigmas = np.interp(timesteps, np.arange(len(sigmas_full)), sigmas_full)

    if cfg.final_sigmas_type == "sigma_min":
        sigma_last = float(((1 - tables.alphas_cumprod[0]) / tables.alphas_cumprod[0]) ** 0.5)
    else:
        sigma_last = 0.0
    sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
    return Schedule(
        timesteps=np.asarray(timesteps, np.int32),
        sigmas=sigmas,
        num_steps=len(timesteps),
    )


class SolverState(NamedTuple):
    """Solver history across the steps of one sampling trajectory."""
    history: torch.Tensor    # [order, *sample_shape] fp32 converted model outputs
    lower_order_nums: int


def init_state(cfg: SolverConfig, sample_shape: Tuple[int, ...], device="cpu") -> SolverState:
    # history always fp32 (solver math runs in an fp32 island, ref :992-993)
    return SolverState(
        history=torch.zeros((cfg.solver_order,) + tuple(sample_shape),
                            dtype=torch.float32, device=device),
        lower_order_nums=0,
    )


_F = np.float32


def _alpha_sigma(sigma) -> Tuple[np.float32, np.float32]:
    sigma = _F(sigma)
    alpha_t = _F(1.0) / (sigma ** _F(2) + _F(1.0)) ** _F(0.5)
    return alpha_t, _F(sigma * alpha_t)


def _lam(sigma) -> np.float32:
    a, s = _alpha_sigma(sigma)
    with np.errstate(divide="ignore"):  # the final sigma 0 gives lambda = +inf
        return _F(np.log(a) - np.log(s))


def _threshold_sample(cfg: SolverConfig, sample: torch.Tensor) -> torch.Tensor:
    """Dynamic thresholding of the x0 prediction (ref _threshold_sample
    :425-457)."""
    shape = sample.shape
    flat = sample.float().reshape(shape[0], -1)
    s = torch.quantile(flat.abs(), cfg.dynamic_thresholding_ratio, dim=1)
    s = torch.clamp(s, 1.0, cfg.sample_max_value)[:, None]
    out = torch.clamp(flat, -s, s) / s
    return out.reshape(shape).to(sample.dtype)


def convert_model_output(cfg: SolverConfig, sigma, model_output: torch.Tensor,
                         sample: torch.Tensor) -> torch.Tensor:
    """ref convert_model_output :528-625, in fp32: data-prediction solvers (++)
    return an x0 prediction, noise-prediction solvers an epsilon prediction."""
    alpha_t, sigma_t = (float(v) for v in _alpha_sigma(sigma))
    model_output = model_output.float()
    sample = sample.float()
    if cfg.data_prediction:
        if cfg.prediction_type == "epsilon":
            x0 = (sample - sigma_t * model_output) / alpha_t
        elif cfg.prediction_type == "sample":
            x0 = model_output
        elif cfg.prediction_type == "v_prediction":
            x0 = alpha_t * sample - sigma_t * model_output
        else:
            raise ValueError(cfg.prediction_type)
        if cfg.thresholding:
            x0 = _threshold_sample(cfg, x0)
        return x0
    if cfg.prediction_type == "epsilon":
        epsilon = model_output
    elif cfg.prediction_type == "sample":
        epsilon = (sample - alpha_t * model_output) / sigma_t
    elif cfg.prediction_type == "v_prediction":
        epsilon = alpha_t * model_output + sigma_t * sample
    else:
        raise ValueError(cfg.prediction_type)
    if cfg.thresholding:
        x0 = (sample - sigma_t * epsilon) / alpha_t
        x0 = _threshold_sample(cfg, x0)
        epsilon = (sample - alpha_t * x0) / sigma_t
    return epsilon


def _first_order(cfg, c, m0, sample, noise):
    """ref dpm_solver_first_order_update :627-694 (scalars in float32)."""
    alpha_t, sigma_t, alpha_s0, sigma_s0, h = c["alpha_t"], c["sigma_t"], c["alpha_s0"], \
        c["sigma_s0"], c["h"]
    if cfg.algorithm_type == "dpmsolver++":
        return float(sigma_t / sigma_s0) * sample - float(alpha_t * (np.exp(-h) - _F(1.0))) * m0
    if cfg.algorithm_type == "dpmsolver":
        return float(alpha_t / alpha_s0) * sample - float(sigma_t * (np.exp(h) - _F(1.0))) * m0
    if cfg.algorithm_type == "sde-dpmsolver++":
        return (float(sigma_t / sigma_s0 * np.exp(-h)) * sample
                + float(alpha_t * (_F(1) - np.exp(_F(-2.0) * h))) * m0
                + float(sigma_t * np.sqrt(_F(1.0) - np.exp(_F(-2) * h))) * noise)
    return (float(alpha_t / alpha_s0) * sample
            - float(_F(2.0) * (sigma_t * (np.exp(h) - _F(1.0)))) * m0
            + float(sigma_t * np.sqrt(np.exp(_F(2) * h) - _F(1.0))) * noise)


def _second_order(cfg, c, m0, m1, sample, noise):
    """ref multistep_dpm_solver_second_order_update :696-817."""
    alpha_t, sigma_t, alpha_s0, sigma_s0, h = c["alpha_t"], c["sigma_t"], c["alpha_s0"], \
        c["sigma_s0"], c["h"]
    r0 = _F(c["h_0"] / h)
    d0, d1 = m0, float(_F(1.0) / r0) * (m0 - m1)
    mid = cfg.solver_type == "midpoint"
    one = _F(1.0)
    if cfg.algorithm_type == "dpmsolver++":
        e = alpha_t * (np.exp(-h) - one)
        if mid:
            return (float(sigma_t / sigma_s0) * sample - float(e) * d0
                    - float(_F(0.5) * e) * d1)
        return (float(sigma_t / sigma_s0) * sample - float(e) * d0
                + float(alpha_t * ((np.exp(-h) - one) / h + one)) * d1)
    if cfg.algorithm_type == "dpmsolver":
        e = sigma_t * (np.exp(h) - one)
        if mid:
            return (float(alpha_t / alpha_s0) * sample - float(e) * d0
                    - float(_F(0.5) * e) * d1)
        return (float(alpha_t / alpha_s0) * sample - float(e) * d0
                - float(sigma_t * ((np.exp(h) - one) / h - one)) * d1)
    if cfg.algorithm_type == "sde-dpmsolver++":
        sde_noise = float(sigma_t * np.sqrt(one - np.exp(_F(-2) * h))) * noise
        e = alpha_t * (one - np.exp(_F(-2.0) * h))
        if mid:
            return (float(sigma_t / sigma_s0 * np.exp(-h)) * sample + float(e) * d0
                    + float(_F(0.5) * e) * d1 + sde_noise)
        return (float(sigma_t / sigma_s0 * np.exp(-h)) * sample + float(e) * d0
                + float(alpha_t * ((one - np.exp(_F(-2.0) * h)) / (_F(-2.0) * h) + one)) * d1
                + sde_noise)
    sde_noise = float(sigma_t * np.sqrt(np.exp(_F(2) * h) - one)) * noise
    e = sigma_t * (np.exp(h) - one)
    if mid:
        return (float(alpha_t / alpha_s0) * sample - float(_F(2.0) * e) * d0
                - float(e) * d1 + sde_noise)
    return (float(alpha_t / alpha_s0) * sample - float(_F(2.0) * e) * d0
            - float(_F(2.0) * (sigma_t * ((np.exp(h) - one) / h - one))) * d1 + sde_noise)


def _third_order(cfg, c, m0, m1, m2, sample):
    """ref multistep_dpm_solver_third_order_update :819-933."""
    alpha_t, sigma_t, alpha_s0, sigma_s0, h = c["alpha_t"], c["sigma_t"], c["alpha_s0"], \
        c["sigma_s0"], c["h"]
    r0, r1 = _F(c["h_0"] / h), _F(c["h_1"] / h)
    one = _F(1.0)
    d0 = m0
    d1_0, d1_1 = float(one / r0) * (m0 - m1), float(one / r1) * (m1 - m2)
    d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
    d2 = float(one / (r0 + r1)) * (d1_0 - d1_1)
    if cfg.algorithm_type == "dpmsolver++":
        return (float(sigma_t / sigma_s0) * sample
                - float(alpha_t * (np.exp(-h) - one)) * d0
                + float(alpha_t * ((np.exp(-h) - one) / h + one)) * d1
                - float(alpha_t * ((np.exp(-h) - one + h) / h ** _F(2) - _F(0.5))) * d2)
    return (float(alpha_t / alpha_s0) * sample
            - float(sigma_t * (np.exp(h) - one)) * d0
            - float(sigma_t * ((np.exp(h) - one) / h - one)) * d1
            - float(sigma_t * ((np.exp(h) - one - h) / h ** _F(2) - _F(0.5))) * d2)


def step(
    cfg: SolverConfig,
    sched: Schedule,
    i: int,
    state: SolverState,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, SolverState]:
    """Solver step `i` (ref step :935-1022).  The order chain mirrors the
    reference (:988-1013): first order while warming up or at the stabilized
    final step, second order next (or at the second-to-last step of short
    schedules), third order once two history entries are live."""
    n = sched.num_steps
    x0f = convert_model_output(cfg, sched.sigmas[i], model_output, sample)
    history = torch.cat([state.history[1:], x0f[None]], dim=0)
    sample32 = sample.float()
    if cfg.is_sde:
        if noise is None:
            raise ValueError(f"{cfg.algorithm_type} needs per-step noise")
        noise = noise.float()

    alpha_t, sigma_t = _alpha_sigma(sched.sigmas[i + 1])
    alpha_s0, sigma_s0 = _alpha_sigma(sched.sigmas[i])
    lam_s0 = _lam(sched.sigmas[i])
    coef = {"alpha_t": alpha_t, "sigma_t": sigma_t, "alpha_s0": alpha_s0,
            "sigma_s0": sigma_s0, "h": _F(_lam(sched.sigmas[i + 1]) - lam_s0)}

    order = 1
    if cfg.solver_order >= 2:
        lower_order_final = i == n - 1 and (
            cfg.euler_at_final or (cfg.lower_order_final and n < 15)
            or cfg.final_sigmas_type == "zero")
        if not (state.lower_order_nums < 1 or lower_order_final):
            order = 2
            if cfg.solver_order == 3:
                lower_order_second = i == n - 2 and cfg.lower_order_final and n < 15
                if not (state.lower_order_nums < 2 or lower_order_second):
                    order = 3

    if order == 1:
        prev = _first_order(cfg, coef, x0f, sample32, noise)
    else:
        lam_s1 = _lam(sched.sigmas[max(i - 1, 0)])
        coef["h_0"] = _F(lam_s0 - lam_s1)
        if order == 2:
            prev = _second_order(cfg, coef, x0f, history[-2], sample32, noise)
        else:
            coef["h_1"] = _F(lam_s1 - _lam(sched.sigmas[max(i - 2, 0)]))
            prev = _third_order(cfg, coef, x0f, history[-2], history[-3], sample32)

    new_lon = min(state.lower_order_nums + 1, cfg.solver_order)
    return prev.to(model_output.dtype), SolverState(history=history, lower_order_nums=new_lon)


def _alpha_sigma_at(tables: SolverTables, original: torch.Tensor,
                    timesteps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """alpha_t and sigma_t at each timestep, in the samples' dtype and on
    their device, shaped to broadcast over the samples' trailing axes."""
    kw = dict(dtype=original.dtype, device=original.device)
    idx = timesteps.to(original.device).long()
    shape = tuple(timesteps.shape) + (1,) * (original.dim() - timesteps.dim())
    a = torch.as_tensor(tables.alpha_t, **kw)[idx].reshape(shape)
    s = torch.as_tensor(tables.sigma_t, **kw)[idx].reshape(shape)
    return a, s


def add_noise(tables: SolverTables, original: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """ref add_noise :1024-1044."""
    a, s = _alpha_sigma_at(tables, original, timesteps)
    return a * original + s * noise


def get_velocity(tables: SolverTables, original: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """ref get_velocity :1046-1062."""
    a, s = _alpha_sigma_at(tables, original, timesteps)
    return a * noise - s * original


__all__ = [
    "SolverConfig",
    "SolverTables",
    "Schedule",
    "SolverState",
    "make_tables",
    "set_timesteps",
    "init_state",
    "step",
    "convert_model_output",
    "add_noise",
    "get_velocity",
]
