"""Training step: LM cross-entropy + diffusion loss, one AdamW update.

Port of `vibevoice_tpu/train.py`.  The reference ships only the
training-shaped forward (`vibevoice/modular/modeling_vibevoice.py:332-477`);
the JAX package adds the step: loss = CE + diffusion MSE and an optax update,
jitted over a `(data, model)` mesh.  Here the update is `torch.optim.AdamW`
driven to reproduce that optax chain step for step (`make_optimizer`), and the
step runs eagerly, on one device or on the ranks of a `parallel.Mesh`.

On a mesh (`make_train_step(..., mesh=)`) each rank holds its
`parallel.shard_params` shard and its data rank's share of the global batch
(`data.shard_batch`); the model axis splits the LM and the head as in
`training_forward`, the gradients are summed over `data` after the backward,
and the optimizer clips by the global norm of the whole tree
(`Optimizer(mesh=, specs=)`), so every rank takes the JAX package's GSPMD
step on the global batch.  The ranks of one data group must draw the same
noise (generators with one seed); ranks of different data groups should not.

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
from .device import resolve_device
from .models import vibevoice
from .parallel.mesh import check_shard_shapes, split_dims
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
# elements per flat all-reduce of the gradients over `data` (128 MB of fp32)
GRAD_BUCKET = 1 << 25


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
    1e-6).

    On a `mesh` the leaves are this rank's shards, and `specs` (the tree's
    `parallel.model_param_specs`, needed with a model axis) says which are
    split over `model`: the global norm is the square root of the split leaves' squares
    summed over the model group plus the whole leaves' counted once, which is
    `optax.global_norm` of the gathered tree.  AdamW stays elementwise on
    each shard, as optax on the sharded tree.  `sync_grads` sums the
    gradients over `data`."""

    def __init__(self, params: Dict[str, Any], lr: float, weight_decay: float,
                 warmup_steps: int, total_steps: int, mesh=None, specs=None):
        self.mesh = mesh
        self.split: List[bool] = []
        if mesh is not None and mesh.group("model") is not None:
            if specs is None:
                raise ValueError("a mesh with a model axis needs the tree's specs "
                                 "(`parallel.model_param_specs`)")
            self.split = [d is not None for d in split_dims(params, specs, "model")]
        self.leaves = trainable(params)
        if self.split and len(self.split) != len(self.leaves):
            raise ValueError(f"the specs name {len(self.split)} floating leaves, the tree "
                             f"holds {len(self.leaves)}")
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
        if self.split:
            sq = torch.stack([torch.linalg.vector_norm(g) for g in grads]) ** 2
            mine = torch.tensor(self.split, device=sq.device)
            split_sq = self.mesh.all_reduce(sq[mine].sum(), "model")
            norm = torch.sqrt(split_sq + sq[~mine].sum())
        else:
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
    def sync_grads(self) -> None:
        """Sum the gradients over the mesh's `data` axis (a no-op without
        one), in flat buckets of at most GRAD_BUCKET elements per dtype.  A
        leaf takes part where any rank of the group has its gradient (one
        small collective of flags first); a rank without it adds zeros."""
        if self.mesh is None or self.mesh.group("data") is None:
            return
        dev = self.leaves[0].device
        flags = torch.tensor([p.grad is not None for p in self.leaves], dtype=torch.int32,
                             device=dev)
        self.mesh.all_reduce(flags, "data", op="max")
        live = [p for p, f in zip(self.leaves, flags.tolist()) if f]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for ps in by_dtype.values():
            bucket, size = [], 0
            for p in ps + [None]:
                if bucket and (p is None or size + p.numel() > GRAD_BUCKET):
                    flat = self.mesh.all_reduce(
                        torch.cat([q.grad.reshape(-1) for q in bucket]), "data")
                    for q, g in zip(bucket, flat.split([q.numel() for q in bucket])):
                        q.grad.copy_(g.view_as(q.grad))
                    bucket, size = [], 0
                if p is not None:
                    bucket.append(p)
                    size += p.numel()

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
                   warmup_steps: int = 100, total_steps: int = 10000, mesh=None,
                   specs=None) -> Optimizer:
    return Optimizer(params, lr, weight_decay, warmup_steps, total_steps, mesh=mesh,
                     specs=specs)


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


def injected_rows(valid: np.ndarray, invalid: np.ndarray, index: int, mul: int) -> np.ndarray:
    """The rows of a global batch's injected noise (or timesteps) that data
    rank `index` takes, in its own packed order.  `valid[r]` / `invalid[r]`
    are rank r's valid and masked-out frames (its clips times F, split by
    `speech_masks`).  The global packed order puts the valid frames of every
    clip first, then the masked-out ones, each repeated `mul` times
    (`training_forward`), and a rank's clips follow the ranks before it in
    both groups; a rank's own order is the same two groups of its frames."""
    valid, invalid = np.asarray(valid, np.int64), np.asarray(invalid, np.int64)
    v0 = valid[:index].sum()
    i0 = valid.sum() + invalid[:index].sum()
    frames = np.concatenate([np.arange(v0, v0 + valid[index]),
                             np.arange(i0, i0 + invalid[index])])
    return (frames[:, None] * mul + np.arange(mul)).reshape(-1)


def make_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer,
                    ddpm_batch_mul: Optional[int] = None,
                    diffusion_loss_weight: float = 1.0, device="cuda", mesh=None):
    """Returns `train_step(params, batch, generator, injected_noise=None,
    injected_timesteps=None) -> metrics` ({"loss", "ce_loss",
    "diffusion_loss"}: 0-d tensors on the device).  It updates the leaves of
    `params` that `optimizer` was made from, in place.  Those, and the
    generator, live on `device` (CUDA unless the caller asks for the CPU);
    the batch moves there.  The injection arguments fix the diffusion noise
    and timesteps, for parity tests.

    On a `mesh` (the optimizer's): `params` are this rank's shards
    (`check_shard_shapes` refuses others), `batch` is its data rank's share
    (`data.shard_batch`), injected noise and timesteps are the global
    batch's (each rank takes its rows, `injected_rows`), the gradients are
    summed over `data` before the clip, and the metrics are summed over
    `data`: every rank reports the global batch's losses."""
    device = resolve_device(device)
    tables = solver_tables(cfg)
    bm = ddpm_batch_mul if ddpm_batch_mul is not None else cfg.diffusion_head.ddpm_batch_mul
    dp_group = None if mesh is None else mesh.group("data")

    def train_step(params, batch: TrainBatch, generator: torch.Generator,
                   injected_noise: Optional[torch.Tensor] = None,
                   injected_timesteps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            check_shard_shapes(params, cfg, mesh.shape["model"], train=True)
        b = _device_batch(batch, device)
        if injected_noise is not None:
            injected_noise = torch.as_tensor(injected_noise).to(device)
            injected_timesteps = torch.as_tensor(injected_timesteps).to(device)
            if dp_group is not None:
                sm = np.asarray(batch.speech_masks)
                counts = torch.tensor([int(sm.sum()), int(sm.size - sm.sum())], device=device)
                per_rank = mesh.all_gather(counts[None], "data").cpu().numpy()
                rows = torch.from_numpy(injected_rows(per_rank[:, 0], per_rank[:, 1],
                                                      mesh.axis_index("data"), bm)).to(device)
                injected_noise = injected_noise[rows]
                injected_timesteps = injected_timesteps[rows]
        optimizer.zero_grad()
        out = vibevoice.training_forward(
            params, cfg, tables, generator,
            input_ids=b.input_ids, attention_mask=b.attention_mask,
            speech_tensors=b.speech_tensors, speech_masks=b.speech_masks,
            speech_semantic_tensors=b.speech_semantic_tensors,
            acoustic_input_mask=b.acoustic_input_mask,
            acoustic_loss_mask=b.acoustic_loss_mask, labels=b.labels,
            ddpm_batch_mul=bm, injected_noise=injected_noise,
            injected_timesteps=injected_timesteps, mesh=mesh)
        loss = out.ce_loss + diffusion_loss_weight * out.diffusion_loss
        loss.backward()
        optimizer.sync_grads()
        optimizer.step()
        metrics = torch.stack([loss, out.ce_loss, out.diffusion_loss]).detach()
        if dp_group is not None:
            metrics = mesh.all_reduce(metrics, "data")
        return dict(zip(("loss", "ce_loss", "diffusion_loss"), metrics.unbind()))

    return train_step


@torch.no_grad()
def init_scaling_stats(params: Dict[str, Any], cfg: VibeVoiceConfig,
                       generator: Optional[torch.Generator], batch: TrainBatch,
                       device="cuda", mesh=None) -> Dict[str, Any]:
    """First-batch scaling/bias computation (ref :307-323): encode the batch's
    speech on `device` (where the params are) and write its statistics into a
    copy of the tree (fp32 0-d); on a `mesh` each data rank's statistics of
    its own share, averaged over the data group (`compute_scaling_stats`).
    Call it before `make_optimizer`, which takes the tree's leaves."""
    b = _device_batch(batch, resolve_device(device))
    latents = vibevoice.encode_voice_prompts(params, cfg, b.speech_tensors, generator)
    scaling, bias = vibevoice.compute_scaling_stats(latents, b.speech_masks, mesh=mesh)
    params = dict(params)
    params["speech_scaling_factor"] = scaling.float()
    params["speech_bias_factor"] = bias.float()
    return params


__all__ = ["TrainBatch", "Optimizer", "make_optimizer", "make_train_step",
           "init_scaling_stats", "injected_rows", "trainable", "solver_tables",
           "warmup_cosine_decay"]
