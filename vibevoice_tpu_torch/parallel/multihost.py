"""Multi-process start-up and data-parallel serving helpers.

Port of `vibevoice_tpu/parallel/multihost.py`.  One process is one rank and,
on the card, one GPU: launch N of them with

    python -m torch.distributed.run --nproc_per_node N your_script.py

and call `initialize()` in each (it reads the launcher's environment), then
`global_mesh(model_parallel)`.  The caller picks the backend: "nccl" by
default on CUDA, "gloo" on the CPU; nothing here switches it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

# finite, so that a collective which one rank never joins fails instead of
# hanging the others for torch's default half hour
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT, device="cuda") -> None:
    """Bring up the default process group (a no-op once one exists).

    `init_method` defaults to "env://" (the launcher's MASTER_ADDR/PORT, RANK,
    WORLD_SIZE); `backend` to "nccl" when `device` is CUDA and "gloo" when it
    is the CPU.  Under NCCL the process takes the card of its LOCAL_RANK (its
    rank modulo the cards, without one)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://", timeout=timeout,
                            **kw)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def global_mesh(model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over every rank: `model_parallel` ranks a model
    group, the rest of the world along `data`."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of {model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel)


def shard_batch_for_host(batch_np, mesh: Mesh):
    """This rank's rows of a global batch: each array's leading axis cut over
    the data axis, the rank keeping its index's part (None stays None)."""
    dp, i = mesh.shape["data"], mesh.axis_index("data")
    out = {}
    for k, v in batch_np.items():
        if v is None:
            out[k] = None
            continue
        v = np.asarray(v)
        if v.shape[0] % dp:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {dp} data ranks")
        n = v.shape[0] // dp
        out[k] = v[i * n:(i + 1) * n]
    return out


def dp_scaling_report(audio_sec: float, wall_s: float) -> dict:
    """Every rank's audio seconds and wall seconds, gathered (float64), into
    the global throughput: total audio over the slowest rank's wall.  One
    process reports its own values.  `hosts` counts the processes."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n > 1:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mine = torch.tensor([audio_sec, wall_s], dtype=torch.float64, device=dev)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        gathered = torch.stack(parts).cpu().numpy()
        audio_total = float(gathered[:, 0].sum())
        wall_max = float(gathered[:, 1].max())
    else:
        audio_total, wall_max = float(audio_sec), float(wall_s)
    return {
        "hosts": n,
        "audio_sec_total": audio_total,
        "throughput": audio_total / wall_max if wall_max else 0.0,
    }


__all__ = ["initialize", "global_mesh", "shard_batch_for_host", "dp_scaling_report",
           "DEFAULT_TIMEOUT"]
