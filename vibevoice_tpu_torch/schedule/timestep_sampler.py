"""Training-time diffusion timestep samplers
(ref `vibevoice/schedule/timestep_sampler.py:5-18`).

The port's copy of `vibevoice_tpu/schedule/timestep_sampler.py`: the draws
come from an explicit `torch.Generator` (on the device the timesteps are
wanted on) where the JAX package splits a key.  Both return int32, as JAX
does.
"""
from __future__ import annotations

import torch


def uniform_sample(generator: torch.Generator, n: int, num_timesteps: int) -> torch.Tensor:
    """UniformSampler: uniform over [0, T)."""
    return torch.randint(0, num_timesteps, (n,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def logit_normal_sample(generator: torch.Generator, n: int, num_timesteps: int,
                        loc: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """LogitNormalSampler: sigmoid(N(loc, scale)) scaled to [0, T)."""
    z = torch.randn((n,), generator=generator, device=generator.device) * scale + loc
    u = torch.sigmoid(z)
    return torch.clamp((u * num_timesteps).to(torch.int32), 0, num_timesteps - 1)


__all__ = ["uniform_sample", "logit_normal_sample"]
