"""Training step: LM cross-entropy + diffusion loss, one AdamW update.

Port of `vibevoice_tpu/train.py`.  The reference ships only the
training-shaped forward (`vibevoice/modular/modeling_vibevoice.py:332-477`);
the JAX package adds the step: loss = CE + diffusion MSE and an optax update,
jitted over a `(data, model)` mesh.  Here the update is `torch.optim.AdamW`
driven to reproduce that optax chain step for step (`make_optimizer`).  On
the card the step is captured, as the JAX step is jitted: the first call for
a batch shape runs one real step, then records forward, backward, the clip
and the AdamW update in one `torch.cuda.CUDAGraph`, which later calls replay
(`make_train_step(..., eager=True)` runs every step from the host).  On the
CPU the step runs eagerly.

On a mesh (`make_train_step(..., mesh=)`) each rank holds its
`parallel.shard_params` shard and its data rank's share of the global batch
(`data.shard_batch`); the model axis splits the LM and the head as in
`training_forward`, the gradients are summed over `data` after the backward,
and the optimizer clips by the global norm of the whole tree
(`Optimizer(mesh=, specs=)`), so every rank takes the JAX package's GSPMD
step on the global batch.  The ranks of one data group must draw the same
noise (generators with one seed); ranks of different data groups should not.
On the card a mesh whose groups are NCCL captures its step with the
collectives in the graph, as the JAX step is one program over the mesh; over
gloo it runs eagerly.

The parameters stay the port's plain tree of tensors in the JAX layouts.
`trainable` makes every floating leaf a leaf tensor that takes a gradient and
lists them in the JAX tree's flattening order (dict keys sorted, None
skipped), the order `jax.tree_util.tree_leaves` gives.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .configs import VibeVoiceConfig
from .device import resolve_device
from .models import vibevoice
from .parallel.mesh import AXES, check_shard_shapes, split_dims
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


class GradPlan(NamedTuple):
    """What `Optimizer.sync_grads` sums over `data`: the leaves that take
    part (a rank's backward gave them a gradient at a step planned so far)
    and their flat buckets, as leaf indices grouped by dtype, at most
    GRAD_BUCKET elements each."""
    live: Tuple[bool, ...]
    buckets: Tuple[Tuple[int, ...], ...]


def grad_buckets(leaves: List[torch.Tensor], live) -> Tuple[Tuple[int, ...], ...]:
    """The live leaves' indices in flat buckets: by dtype (in the order the
    dtypes first appear), each bucket at most GRAD_BUCKET elements (a larger
    leaf alone)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (p, on) in enumerate(zip(leaves, live)):
        if on:
            by_dtype.setdefault(p.dtype, []).append(i)
    buckets = []
    for idx in by_dtype.values():
        bucket, size = [], 0
        for i in idx:
            if bucket and size + leaves[i].numel() > GRAD_BUCKET:
                buckets.append(tuple(bucket))
                bucket, size = [], 0
            bucket.append(i)
            size += leaves[i].numel()
        buckets.append(tuple(bucket))
    return tuple(buckets)


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
    gradients over `data` by the plan that `plan_grads` makes.  Nothing of
    `sync_grads` and `update` reads the host: a captured step records them.

    On the card (leaves on CUDA) the AdamW update is capturable and reads its
    learning rate from a 0-d fp32 tensor on the card, which `set_lr` writes
    before each update: a captured step then takes the same arithmetic as an
    eager one.  On the CPU the learning rate is a host float, as in
    `torch.optim.AdamW`'s default form."""

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
        # the clip's split and whole leaves as index tensors on the leaves'
        # device, made once: a list would be copied in at every update, and
        # a boolean index gives a shape that the host reads
        self._split_rows = self._whole_rows = None
        if self.split:
            rows = lambda want: torch.tensor([i for i, s in enumerate(self.split) if s == want],
                                             dtype=torch.long, device=self.leaves[0].device)
            self._split_rows, self._whole_rows = rows(True), rows(False)
        self.plan: Optional[GradPlan] = None
        self.lr, self.warmup_steps, self.total_steps = lr, warmup_steps, total_steps
        self.count = 0  # updates applied (optax's schedule count)
        decay = [p for p in self.leaves if p.dim() > 1]
        rest = [p for p in self.leaves if p.dim() <= 1]
        on_card = bool(self.leaves) and self.leaves[0].is_cuda
        card_lr = dict(lr=torch.zeros((), dtype=torch.float32, device=self.leaves[0].device),
                       capturable=True) if on_card else dict(lr=0.0)
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            betas=(0.9, 0.95), eps=1e-8, **card_lr)

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
            split_sq = self.mesh.all_reduce(sq.index_select(0, self._split_rows).sum(), "model")
            norm = torch.sqrt(split_sq + sq.index_select(0, self._whole_rows).sum())
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

    def plan_grads(self) -> bool:
        """Plan `sync_grads` from the gradients the backward just left: which
        leaves any rank of the `data` group has a gradient for (one small
        collective of flags, read on the host: never part of a captured
        step), added to the leaves planned before, and their buckets.  Every
        rank of the group must call it at the same step.  Returns whether the
        plan changed (it is the same on every rank).  A no-op without a data
        axis.  A leaf planned at an earlier step but without a gradient now
        takes part with zeros, which leaves the sum as it would be without it:
        `update` gives such a leaf a zero gradient anyway."""
        if self.mesh is None or self.mesh.group("data") is None:
            return False
        flags = torch.tensor([p.grad is not None for p in self.leaves], dtype=torch.int32,
                             device=self.leaves[0].device)
        self.mesh.all_reduce(flags, "data", op="max")
        old = self.plan.live if self.plan is not None else (False,) * len(self.leaves)
        live = tuple(bool(f) or o for f, o in zip(flags.tolist(), old))
        if self.plan is not None and live == self.plan.live:
            return False
        self.plan = GradPlan(live, grad_buckets(self.leaves, live))
        return True

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Sum the gradients over the mesh's `data` axis by the plan
        (`plan_grads`), one flat all-reduce per bucket; a planned leaf without
        a gradient on this rank adds zeros.  It reads nothing from the host,
        so a captured step records it.  A no-op without a data axis."""
        if self.mesh is None or self.mesh.group("data") is None:
            return
        if self.plan is None:
            raise RuntimeError("sync_grads before plan_grads: the ranks have not said which "
                               "leaves take part")
        for bucket in self.plan.buckets:
            ps = [self.leaves[i] for i in bucket]
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = self.mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in ps]), "data")
            for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad.copy_(g.view_as(p.grad))

    def set_lr(self) -> float:
        """Write the schedule's learning rate for the next update into the
        param groups (on the card: into their lr tensors, outside any
        captured step); returns it."""
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr
        return lr

    @torch.no_grad()
    def update(self) -> None:
        """The device half of `step`: zero gradients for the leaves without
        one, the clip and the AdamW update at the learning rate `set_lr`
        wrote.  A captured train step records this."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip_()
        self.adamw.step()

    def step(self) -> None:
        """One update from the leaves' gradients."""
        self.set_lr()
        self.update()
        self.count += 1


def make_optimizer(params: Dict[str, Any], lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10000, mesh=None,
                   specs=None) -> Optimizer:
    return Optimizer(params, lr, weight_decay, warmup_steps, total_steps, mesh=mesh,
                     specs=specs)


def _host_batch(batch: TrainBatch) -> TrainBatch:
    """The batch as CPU tensors in the dtypes the step takes."""
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dtype)
    return TrainBatch(
        input_ids=put(batch.input_ids, torch.int64),
        attention_mask=put(batch.attention_mask, torch.int64),
        labels=put(batch.labels, torch.int64),
        speech_tensors=put(batch.speech_tensors, torch.float32),
        speech_masks=put(batch.speech_masks, torch.bool),
        speech_semantic_tensors=put(batch.speech_semantic_tensors, torch.float32),
        acoustic_input_mask=put(batch.acoustic_input_mask, torch.bool),
        acoustic_loss_mask=put(batch.acoustic_loss_mask, torch.bool))


def _device_batch(batch: TrainBatch, device) -> TrainBatch:
    return TrainBatch(*(t.to(device) for t in _host_batch(batch)))


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


def select_injected(noise, timesteps, valid, invalid, index: int,
                    mul: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data rank `index`'s rows (`injected_rows`) of a global batch's
    injected noise and timesteps, taken where they lie (on the host, before
    the step copies them in)."""
    rows = torch.from_numpy(injected_rows(valid, invalid, index, mul))
    noise, timesteps = torch.as_tensor(noise), torch.as_tensor(timesteps)
    return noise[rows.to(noise.device)], timesteps[rows.to(timesteps.device)]


def must_capture(fresh_flags) -> bool:
    """Whether this call warms up and captures (eager: plans the gradient
    sum) on every rank: when any data rank meets a batch it has no graph (or
    plan) for.  Each rank applies it to the same gathered flags, so all take
    one path: a rank replaying real collectives while another only recorded
    them into a graph would hang both."""
    return bool(np.asarray(fresh_flags).any())


class _Captured(NamedTuple):
    graph: Any                  # torch.cuda.CUDAGraph (keep_graph: its nodes can be read)
    inputs: List[torch.Tensor]  # the static batch (and injected noise, timesteps)
    metrics: torch.Tensor       # [3] static output: loss, ce_loss, diffusion_loss


METRICS = ("loss", "ce_loss", "diffusion_loss")


def _capture_refusal(mesh) -> Optional[str]:
    """Why a train step on `mesh` cannot be captured (None when it can): each
    axis of size > 1 needs its process group, and every group the mesh holds
    must be NCCL (gloo's collectives are not CUDA work)."""
    for axis in AXES:
        if mesh.group(axis) is None:
            if mesh.shape[axis] > 1:
                return f"its {axis!r} axis of {mesh.shape[axis]} has no process group"
        elif mesh.backend(axis) != "nccl":
            return f"its {axis!r} group is {mesh.backend(axis)}, not NCCL"
    return None


class TrainStep:
    """`make_train_step`'s step.  On the card, unless `eager`, it follows
    `engine.generate.Engine`'s rule: the first call for a batch's shapes
    (with or without injected noise, with or without a generator) runs one
    real step on a side stream, then captures forward, backward, the
    gradient sum over `data`, `Optimizer.update` (the clip and AdamW) and the
    metrics' sum over `data` in a `torch.cuda.CUDAGraph` with the step's
    generator registered; a later call copies its batch into that graph's
    static buffers, writes the learning rate into the optimizer's lr tensors
    and replays.  The graphs share one memory pool.  A failed capture
    raises: there is no eager fallback.

    On a mesh the host work stays out of what is captured: per call,
    `check_shard_shapes`, one small collective over `data` before the step
    (each rank's frame counts and whether it meets a new batch shape), the
    rank's rows of the injected noise and timesteps (`select_injected`) and
    `set_lr`.  When any data rank meets a new shape, every rank warms up and
    captures (`must_capture`); the warm-up also plans the gradient sum
    (`Optimizer.plan_grads`), and a changed plan drops every graph.  The
    eager step runs the same body and plans at the same calls.

    `graphs` (by key), `captures`, `capture_s` (the last capture's seconds)
    and `replays` say what it did."""

    def __init__(self, cfg: VibeVoiceConfig, optimizer: Optimizer,
                 ddpm_batch_mul: Optional[int], diffusion_loss_weight: float, device,
                 mesh, eager: bool):
        self.device = resolve_device(device)
        if mesh is not None and not eager:
            why = _capture_refusal(mesh)
            if why is not None:
                raise ValueError(f"a train step on this mesh cannot be captured in a CUDA graph "
                                 f"({why}): pass eager=True, or use NCCL process groups")
        self.cfg, self.optimizer, self.mesh = cfg, optimizer, mesh
        self.loss_weight = diffusion_loss_weight
        self.mul = (ddpm_batch_mul if ddpm_batch_mul is not None
                    else cfg.diffusion_head.ddpm_batch_mul)
        # on the device once: a host-to-device copy cannot be captured
        self.tables = ds.SolverTables(*(torch.as_tensor(np.asarray(x), device=self.device)
                                        for x in solver_tables(cfg)))
        self.dp_group = None if mesh is None else mesh.group("data")
        self.use_graph = self.device.type == "cuda" and not eager
        self.graphs: Dict[tuple, _Captured] = {}
        self._seen: set = set()  # the eager step's planned keys
        self.pool = None
        self.captures = 0
        self.capture_s: Optional[float] = None
        self.replays = 0
        self._rng: Optional[torch.Generator] = None

    def _forward_backward(self, params, b: TrainBatch, generator, noise,
                          timesteps) -> torch.Tensor:
        """The losses and their gradients in the leaves' `.grad`; returns
        [loss, ce_loss, diffusion_loss]."""
        out = vibevoice.training_forward(
            params, self.cfg, self.tables, generator,
            input_ids=b.input_ids, attention_mask=b.attention_mask,
            speech_tensors=b.speech_tensors, speech_masks=b.speech_masks,
            speech_semantic_tensors=b.speech_semantic_tensors,
            acoustic_input_mask=b.acoustic_input_mask,
            acoustic_loss_mask=b.acoustic_loss_mask, labels=b.labels,
            ddpm_batch_mul=self.mul, injected_noise=noise, injected_timesteps=timesteps,
            mesh=self.mesh)
        loss = out.ce_loss + self.loss_weight * out.diffusion_loss
        loss.backward()
        return torch.stack([loss, out.ce_loss, out.diffusion_loss]).detach()

    def _body(self, params, inputs: List[torch.Tensor], generator,
              plan: bool = False) -> torch.Tensor:
        """What a captured step records: forward and backward (with the model
        axis's collectives), the gradient sum over `data`, the update and the
        metrics' sum over `data`.  With `plan` (the first step of a new
        shape: a warm-up or an eager step, never a capture) the gradient sum
        is planned first, and a changed plan drops every graph."""
        b = TrainBatch(*inputs[:len(TrainBatch._fields)])
        noise, timesteps = (inputs[len(TrainBatch._fields):] + [None, None])[:2]
        metrics = self._forward_backward(params, b, generator, noise, timesteps)
        opt = self.optimizer
        if plan and opt.plan_grads():
            self.graphs.clear()
        opt.sync_grads()
        opt.update()
        if self.dp_group is not None:
            metrics = self.mesh.all_reduce(metrics, "data")
        return metrics

    def __call__(self, params, batch: TrainBatch, generator: Optional[torch.Generator],
                 injected_noise=None, injected_timesteps=None) -> Dict[str, torch.Tensor]:
        opt = self.optimizer
        host, key, fresh = self._prepare(params, batch, generator, injected_noise,
                                         injected_timesteps)
        opt.set_lr()
        if self.use_graph:
            metrics = self._graph_step(params, host, generator, key, fresh)
        else:
            opt.zero_grad()
            metrics = self._body(params, [t.to(self.device) for t in host], generator, fresh)
            self._seen.add(key)
        opt.count += 1
        return dict(zip(METRICS, metrics.unbind()))

    def _prepare(self, params, batch: TrainBatch, generator, injected_noise,
                 injected_timesteps) -> Tuple[List[torch.Tensor], tuple, bool]:
        """The host's work before a step, none of it captured: the shard
        check, the batch as host tensors, the step's key, the exchange over
        `data` and the capture decision it gives (`must_capture`), and this
        rank's rows of the injected noise and timesteps.  Returns (the
        step's inputs on the host, its key, whether every rank warms up and
        captures, or plans)."""
        mesh = self.mesh
        if mesh is not None:
            check_shard_shapes(params, self.cfg, mesh.shape["model"], train=True)
        host = list(_host_batch(batch))
        injected = None
        if injected_noise is not None:
            injected = [torch.as_tensor(injected_noise), torch.as_tensor(injected_timesteps)]
        key = (tuple((tuple(t.shape), t.dtype) for t in host + (injected or [])),
               generator is None)
        table = self._exchange(batch, key not in (self.graphs if self.use_graph else self._seen))
        if injected is not None:
            if self.dp_group is not None:
                injected = select_injected(*injected, table[:, 0], table[:, 1],
                                           mesh.axis_index("data"), self.mul)
            host += injected
        return host, key, must_capture(table[:, 2])

    def _exchange(self, batch: TrainBatch, fresh: bool) -> np.ndarray:
        """[data ranks, 3] int64: each data rank's valid and masked-out frames
        and whether it meets a new key, gathered over `data` before the step
        (one small collective on the host's path; this rank's row alone
        without a data axis)."""
        sm = np.asarray(batch.speech_masks)
        mine = np.array([[sm.sum(), sm.size - sm.sum(), fresh]], np.int64)
        if self.dp_group is None:
            return mine
        where = self.device if self.mesh.backend("data") == "nccl" else "cpu"
        return self.mesh.all_gather(torch.from_numpy(mine).to(where), "data").cpu().numpy()

    def _graph_step(self, params, host, generator, key, fresh):
        rng = None
        if generator is not None:
            # the caller's generator state goes into the one the graphs draw
            # from, and comes back advanced by the step's draws
            if self._rng is None:
                self._rng = torch.Generator(device=self.device)
            self._rng.set_state(generator.get_state())
            rng = self._rng
        if fresh:
            metrics = self._capture(params, [t.to(self.device, copy=True) for t in host], rng,
                                    key)
        else:
            cap = self.graphs[key]
            for dst, src in zip(cap.inputs, host):
                dst.copy_(src)
            cap.graph.replay()
            self.replays += 1
            metrics = cap.metrics.clone()  # the next replay overwrites the static output
        if generator is not None:
            generator.set_state(self._rng.get_state())
        return metrics

    def _capture(self, params, inputs, rng, key) -> torch.Tensor:
        """Warm one step up on a side stream (a real step, which plans the
        gradient sum and makes every group's communicator: its metrics are
        this call's), then capture one step on that stream into the shared
        pool.  The warm-up's gradients are dropped first, so that the
        capture's backward makes the graph's own, static ones."""
        dev, opt = self.device, self.optimizer
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            opt.zero_grad()
            metrics = self._body(params, inputs, rng, plan=True)
        torch.cuda.current_stream(dev).wait_stream(stream)
        opt.zero_grad()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if rng is not None:
            graph.register_generator_state(rng)
        # entering frees the warm-up's cached blocks (empty_cache) first
        with torch.cuda.graph(graph, pool=self.pool, stream=stream):
            out = self._body(params, inputs, rng)
        graph.instantiate()
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
        self.graphs[key] = _Captured(graph, inputs, out)
        return metrics


def make_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer,
                    ddpm_batch_mul: Optional[int] = None,
                    diffusion_loss_weight: float = 1.0, device="cuda", mesh=None,
                    eager: bool = False) -> TrainStep:
    """Returns `train_step(params, batch, generator, injected_noise=None,
    injected_timesteps=None) -> metrics` ({"loss", "ce_loss",
    "diffusion_loss"}: 0-d tensors on the device).  It updates the leaves of
    `params` that `optimizer` was made from, in place.  Those, and the
    generator, live on `device` (CUDA unless the caller asks for the CPU);
    the batch moves there.  The injection arguments fix the diffusion noise
    and timesteps, for parity tests.  A step without them draws from
    `generator`, which it advances as an eager step would.

    On the card the step is captured (`TrainStep`); `eager=True` runs it from
    the host, for comparisons.  On the CPU it always runs eagerly.

    On a `mesh` (the optimizer's): `params` are this rank's shards
    (`check_shard_shapes` refuses others), `batch` is its data rank's share
    (`data.shard_batch`), injected noise and timesteps are the global
    batch's (each rank takes its rows, `injected_rows`), the gradients are
    summed over `data` before the clip, and the metrics are summed over
    `data`: every rank reports the global batch's losses.  Every rank of the
    mesh calls the step together.  A mesh needs `eager=True` unless every
    process group it holds is NCCL (and every axis larger than 1 has one):
    ValueError otherwise."""
    return TrainStep(cfg, optimizer, ddpm_batch_mul, diffusion_loss_weight, device, mesh,
                     eager)


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


__all__ = ["TrainBatch", "Optimizer", "TrainStep", "make_optimizer", "make_train_step",
           "init_scaling_stats", "injected_rows", "trainable", "solver_tables",
           "warmup_cosine_decay"]
