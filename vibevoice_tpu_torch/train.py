"""Training step: LM cross-entropy + diffusion loss, one AdamW update.

Port of `vibevoice_tpu/train.py`.  The reference ships only the
training-shaped forward (`vibevoice/modular/modeling_vibevoice.py:332-477`);
the JAX package adds the step: loss = CE + diffusion MSE and an optax update.
Here the update is `torch.optim.AdamW` driven to reproduce that optax chain
step for step (`make_optimizer`), and the step runs eagerly on one device.

The parameters stay the port's plain tree of tensors in the JAX layouts.
`trainable` makes every floating leaf a leaf tensor that takes a gradient and
lists them in the JAX tree's flattening order (dict keys sorted, None
skipped), the order `jax.tree_util.tree_leaves` gives.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .configs import VibeVoiceConfig
from .engine.generate import resolve_device
from .models import vibevoice
from .schedule import dpm_solver as ds


class TrainBatch(NamedTuple):
    """numpy arrays (`data.build_training_batch`); `train_step` moves them to
    the device."""
    input_ids: np.ndarray                # [B, T]
    attention_mask: np.ndarray           # [B, T]
    labels: np.ndarray                   # [B, T] (-100 ignore)
    speech_tensors: np.ndarray           # [N, Ta]
    speech_masks: np.ndarray             # [N, F]
    speech_semantic_tensors: np.ndarray  # [N, F, sem]
    acoustic_input_mask: np.ndarray      # [B, T]
    acoustic_loss_mask: np.ndarray       # [B, T]


def _walk(tree: Any, fn) -> Any:
    """The tree with every tensor leaf replaced by fn(leaf), in the JAX
    flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            tree[k] = _walk(tree[k], fn)
        return tree
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            tree[i] = _walk(v, fn)
        return tree
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def trainable(params: Dict[str, Any]) -> List[torch.Tensor]:
    """Make every floating leaf of `params` (in place) a leaf tensor with
    `requires_grad=True`; returns them flat, in the JAX tree's order."""
    leaves: List[torch.Tensor] = []

    def take(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            return t
        if not t.is_leaf:
            t = t.detach()
        leaves.append(t.requires_grad_(True))
        return t

    _walk(params, take)
    return leaves


def warmup_cosine_decay(count: int, peak: float, warmup_steps: int,
                        decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps)
    at `count`: a linear warm-up from 0, then a cosine decay to 0 over the
    rest of `decay_steps` (which counts the warm-up)."""
    if count < warmup_steps:
        return -peak * (1.0 - count / warmup_steps) + peak
    rest = decay_steps - warmup_steps
    c = min(count - warmup_steps, rest)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / rest))


MAX_GRAD_NORM = 1.0


class Optimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay(0, lr,
    warmup, total), b1=0.9, b2=0.95, weight_decay=wd, mask=ndim > 1)) over the
    trainable leaves of a parameter tree.

    `step()` reads the leaves' `.grad`.  Every leaf takes part in every
    update, as every leaf of a JAX tree gets a gradient: a leaf that autograd
    left without one (the frozen tokenizers, an unused connector) gets zeros,
    so its Adam update is zero and its weight decay still applies, as in
    optax.  The global norm clip is optax's (`g / norm * max_norm` where
    norm >= max_norm), not `clip_grad_norm_`'s (which divides by norm +
    1e-6)."""

    def __init__(self, params: Dict[str, Any], lr: float, weight_decay: float,
                 warmup_steps: int, total_steps: int):
        self.leaves = trainable(params)
        self.lr, self.warmup_steps, self.total_steps = lr, warmup_steps, total_steps
        self.count = 0  # updates applied (optax's schedule count)
        decay = [p for p in self.leaves if p.dim() > 1]
        rest = [p for p in self.leaves if p.dim() <= 1]
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=0.0, betas=(0.9, 0.95), eps=1e-8)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup_steps, self.total_steps)

    @torch.no_grad()
    def clip_(self) -> torch.Tensor:
        """Scale the gradients to a global norm of at most MAX_GRAD_NORM, in
        place; returns the norm before clipping (0-d, on the device)."""
        grads = [p.grad for p in self.leaves]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # g / 1 * 1 == g exactly below the threshold: no read of the norm on
        # the host
        keep = norm < MAX_GRAD_NORM
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, MAX_GRAD_NORM)
        for g in grads:
            g.div_(div).mul_(mul)
        return norm

    @torch.no_grad()
    def step(self) -> None:
        """One update from the leaves' gradients."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip_()
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1


def make_optimizer(params: Dict[str, Any], lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10000) -> Optimizer:
    return Optimizer(params, lr, weight_decay, warmup_steps, total_steps)


def _device_batch(batch: TrainBatch, device) -> TrainBatch:
    def put(a, dtype=None):
        t = torch.as_tensor(np.asarray(a))
        return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return TrainBatch(
        input_ids=put(batch.input_ids, torch.int64),
        attention_mask=put(batch.attention_mask, torch.int64),
        labels=put(batch.labels, torch.int64),
        speech_tensors=put(batch.speech_tensors, torch.float32),
        speech_masks=put(batch.speech_masks, torch.bool),
        speech_semantic_tensors=put(batch.speech_semantic_tensors, torch.float32),
        acoustic_input_mask=put(batch.acoustic_input_mask, torch.bool),
        acoustic_loss_mask=put(batch.acoustic_loss_mask, torch.bool))


def solver_tables(cfg: VibeVoiceConfig) -> ds.SolverTables:
    return ds.make_tables(ds.SolverConfig(
        num_train_timesteps=cfg.diffusion_head.ddpm_num_steps,
        beta_schedule=cfg.diffusion_head.ddpm_beta_schedule,
        prediction_type=cfg.diffusion_head.prediction_type))


def make_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer,
                    ddpm_batch_mul: Optional[int] = None,
                    diffusion_loss_weight: float = 1.0, device="cuda"):
    """Returns `train_step(params, batch, generator, injected_noise=None,
    injected_timesteps=None) -> metrics` ({"loss", "ce_loss",
    "diffusion_loss"}: 0-d tensors on the device).  It updates the leaves of
    `params` that `optimizer` was made from, in place.  Those, and the
    generator, live on `device` (CUDA unless the caller asks for the CPU);
    the batch moves there.  The injection arguments fix the diffusion noise
    and timesteps, for parity tests."""
    device = resolve_device(device)
    tables = solver_tables(cfg)
    bm = ddpm_batch_mul if ddpm_batch_mul is not None else cfg.diffusion_head.ddpm_batch_mul

    def train_step(params, batch: TrainBatch, generator: torch.Generator,
                   injected_noise: Optional[torch.Tensor] = None,
                   injected_timesteps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b = _device_batch(batch, device)
        if injected_noise is not None:
            injected_noise = torch.as_tensor(injected_noise).to(device)
            injected_timesteps = torch.as_tensor(injected_timesteps).to(device)
        optimizer.zero_grad()
        out = vibevoice.training_forward(
            params, cfg, tables, generator,
            input_ids=b.input_ids, attention_mask=b.attention_mask,
            speech_tensors=b.speech_tensors, speech_masks=b.speech_masks,
            speech_semantic_tensors=b.speech_semantic_tensors,
            acoustic_input_mask=b.acoustic_input_mask,
            acoustic_loss_mask=b.acoustic_loss_mask, labels=b.labels,
            ddpm_batch_mul=bm, injected_noise=injected_noise,
            injected_timesteps=injected_timesteps)
        loss = out.ce_loss + diffusion_loss_weight * out.diffusion_loss
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "ce_loss": out.ce_loss.detach(),
                "diffusion_loss": out.diffusion_loss.detach()}

    return train_step


@torch.no_grad()
def init_scaling_stats(params: Dict[str, Any], cfg: VibeVoiceConfig,
                       generator: Optional[torch.Generator], batch: TrainBatch,
                       device="cuda") -> Dict[str, Any]:
    """First-batch scaling/bias computation (ref :307-323): encode the batch's
    speech on `device` (where the params are) and write its statistics into a
    copy of the tree (fp32 0-d).  Call it before `make_optimizer`, which
    takes the tree's leaves."""
    b = _device_batch(batch, resolve_device(device))
    latents = vibevoice.encode_voice_prompts(params, cfg, b.speech_tensors, generator)
    scaling, bias = vibevoice.compute_scaling_stats(latents, b.speech_masks)
    params = dict(params)
    params["speech_scaling_factor"] = scaling.float()
    params["speech_bias_factor"] = bias.float()
    return params


__all__ = ["TrainBatch", "Optimizer", "make_optimizer", "make_train_step",
           "init_scaling_stats", "trainable", "solver_tables", "warmup_cosine_decay"]
