"""The (data, model) mesh as process groups, and the sharding rules.

Port of `vibevoice_tpu/parallel/mesh.py`.  The JAX package expresses the
reference's HF tensor-parallel plan (`configuration_vibevoice.py:175-183`) as
GSPMD `PartitionSpec`s over a `(data, model)` device mesh and lets XLA insert
the collectives.  Here one process is one rank, a rank holds ITS OWN SHARD of
every parameter as ordinary local tensors, and the collectives are explicit
`torch.distributed` calls made outside the kernels:

  * `model` axis: attention heads and the MLP hidden split (q/k/v/gate/up by
    column, o/down by row), the KV cache's fused KVH*D lanes with the heads,
    and the diffusion head's FFN hidden the same way; the row-split products
    are summed over the axis's group (`Mesh.all_reduce`);
  * `data` axis: utterance batches, each rank serving its own rows.

A spec is a tuple of axis names or None per leading tensor axis (the JAX
package's `P(None, "model")` is `(None, "model")`, `P()` is `()`); the trees
are the JAX package's, leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import VibeVoiceConfig

AXES = ("data", "model")


class Mesh:
    """A (data, model) mesh over the ranks of the default process group, in
    the JAX layout: `np.arange(data * model).reshape(data, model)`, so rank
    `d * model + m` sits at (d, m).  It holds this rank's coordinates and the
    process group of each axis that it belongs to (None for an axis of size 1,
    which needs no collective).  Build it with `make_mesh`, on every rank."""

    def __init__(self, data: int, model: int, rank: int, groups: Dict[str, Any]):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        # (data, model) coordinates; None for a rank beyond data * model
        self.coords = (rank // model, rank % model) if rank < data * model else None
        self._groups = groups

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis` (the JAX package's `lax.axis_index`)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's `axis` (None when the axis has size 1)."""
        return self._groups.get(axis)

    def backend(self, axis: str) -> Optional[str]:
        """The backend of this rank's `axis` group ("nccl", "gloo"), or None
        when the axis has size 1."""
        g = self.group(axis)
        return None if g is None else dist.get_backend(g)

    def all_reduce(self, x: torch.Tensor, axis: str = "model", op: str = "sum") -> torch.Tensor:
        """Reduce `x` in place over the axis's group ("sum" or "max"); a
        no-op on an axis of size 1.  Returns `x`."""
        g = self.group(axis)
        if g is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                            group=g)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The axis's ranks' `x`, concatenated along `dim` in rank order (the
        JAX package's tiled `lax.all_gather`); `x` itself on an axis of size 1."""
        g = self.group(axis)
        if g is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts, dim=dim)


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the default process group, or over this one
    process when there is none.  Every rank must call it, with the same sizes:
    it creates the axes' groups with `dist.new_group`, every group in the same
    order on every rank (a rank that skipped one would deadlock the others).
    Raises ValueError when the world holds fewer than data * model ranks."""
    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world < n:
        raise ValueError(f"need {n} processes, have {world}")
    devs = np.arange(n).reshape(data, model)
    groups: Dict[str, Any] = {}
    # rows of the layout are the model groups, columns the data groups
    for axis, lines in (("model", list(devs)), ("data", list(devs.T))):
        if len(lines[0]) < 2:
            continue
        for ranks in lines:
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = g
    return Mesh(data, model, rank, groups)


def _linear_col(bias: bool = True):
    """Output-dim (column) sharded linear: w [in, out_sharded]."""
    return {"w": (None, "model"), "b": ("model",) if bias else None}


def _linear_row():
    """Input-dim (row) sharded linear: w [in_sharded, out]."""
    return {"w": ("model", None), "b": None}


def _replicated_like(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _replicated_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated_like(v) for v in tree]
    return ()


def qwen2_param_specs(n_layers: int) -> Dict[str, Any]:
    layer = {
        "input_norm_w": (),
        "q": _linear_col(), "k": _linear_col(), "v": _linear_col(),
        "o": _linear_row(),
        "post_norm_w": (),
        "gate": (None, "model"), "up": (None, "model"), "down": ("model", None),
    }
    return {
        "embed": (None, None),
        "layers": [dict(layer) for _ in range(n_layers)],
        "final_norm_w": (),
    }


def model_param_specs(params: Dict[str, Any], cfg: VibeVoiceConfig) -> Dict[str, Any]:
    """The spec tree of a `vibevoice.init_model` tree (the JAX package's)."""
    return {
        "lm": qwen2_param_specs(cfg.decoder.num_hidden_layers),
        # the conv stacks are small: replicated
        "acoustic_encoder": _replicated_like(params["acoustic_encoder"]),
        "acoustic_decoder": _replicated_like(params["acoustic_decoder"]),
        "semantic_encoder": _replicated_like(params["semantic_encoder"]),
        "acoustic_connector": _replicated_like(params["acoustic_connector"]),
        "semantic_connector": _replicated_like(params["semantic_connector"]),
        "diffusion_head": {
            "noisy_proj": (), "cond_proj": (), "t_mlp1": (), "t_mlp2": (),
            "layers": [
                {"ada_w": (), "norm_w": (),
                 "gate": (None, "model"), "up": (None, "model"),
                 "down": ("model", None)}
                for _ in range(cfg.diffusion_head.head_layers)
            ],
            "final_ada_w": (), "final_linear": (),
        },
        "speech_scaling_factor": (),
        "speech_bias_factor": (),
        "lm_head": None if params.get("lm_head") is None else (None, "model"),
    }


def adapt_specs_to_quantized(params, specs):
    """Reconcile the plain-weight specs with an int8-quantized tree
    (`utils.quantize`): where the params hold `{"qint8", "scale"}` in place of
    a weight, the int8 matrix keeps the weight's spec and the per-output-channel
    scale takes the OUT axis's (column-split weights split their scales,
    row-split ones replicate them).  Keys the specs do not name (kernel packs)
    are replicated.  int4's fused qkv/gateup layout is refused with
    ValueError, as in the JAX package: quantize with mode="int8" to shard."""
    if isinstance(params, dict) and "qint8" in params:
        wspec = specs if isinstance(specs, tuple) else ()
        out_axis = wspec[-1] if len(wspec) >= 2 else None
        return {"qint8": wspec, "scale": (out_axis,)}
    if isinstance(params, dict):
        if not isinstance(specs, dict):
            raise ValueError(
                "param tree has keys the specs lack — int4's fused layout is "
                "not TP-adaptable; quantize with mode='int8' for sharding")
        return {k: (adapt_specs_to_quantized(params[k], specs[k])
                    if k in specs else _replicated_like(params[k]))
                for k in params}
    if isinstance(params, list):
        return [adapt_specs_to_quantized(p, s) for p, s in zip(params, specs)]
    return specs


def _shard_leaf(x: torch.Tensor, spec, mesh: Mesh, path: str) -> torch.Tensor:
    for axis_pos, name in enumerate(spec or ()):
        if name is None:
            continue
        n, i = mesh.shape[name], mesh.axis_index(name)
        if x.shape[axis_pos] % n:
            raise ValueError(f"{path}: axis {axis_pos} of {tuple(x.shape)} does not split "
                             f"over the {n} ranks of '{name}'")
        size = x.shape[axis_pos] // n
        x = x.narrow(axis_pos, i * size, size).contiguous()
    return x


def _shard(x, spec, mesh: Mesh, path: str):
    if x is None:
        return None
    if isinstance(spec, dict):
        return {k: _shard(v, spec[k], mesh, f"{path}/{k}") for k, v in x.items()}
    if isinstance(spec, list):
        return [_shard(v, s, mesh, f"{path}/{i}") for i, (v, s) in enumerate(zip(x, spec))]
    if torch.is_tensor(x):
        return _shard_leaf(x, spec, mesh, path)
    if spec:
        raise ValueError(f"{path}: spec {spec} names an axis of a node that is not a tensor")
    return x  # a replicated subtree (kernel packs) stays as it is


def shard_params(params, mesh: Mesh, specs=None, cfg: Optional[VibeVoiceConfig] = None):
    """This rank's shard of every leaf: an axis named in the leaf's spec is cut
    into the axis's size and this rank keeps its index's part (a column split
    on the last axis, a row split on the first); replicated leaves are the
    same tensors.  The counterpart of the JAX package's `shard_params`, whose
    shard on device (d, m) this rank's equals."""
    if specs is None:
        specs = model_param_specs(params, cfg)
    specs = adapt_specs_to_quantized(params, specs)
    return _shard(params, specs, mesh, "params")


def _out_width(w) -> int:
    if isinstance(w, dict):
        return (w["qint8"] if "qint8" in w else w["qint4"]).shape[-1]
    return w.shape[-1]


def _in_width(w) -> int:
    if isinstance(w, dict):
        return w["qint8"].shape[0] if "qint8" in w else 2 * w["qint4"].shape[0]
    return w.shape[0]


def check_shard_shapes(params, cfg: VibeVoiceConfig, mp: int, train: bool = False):
    """ValueError unless every split weight has the shape of a 1/mp shard
    (mp = 1: of the whole weight): the q/k/v and gate/up outputs and the o and
    down inputs of every LM layer, and the diffusion head's FFN.  Heads split
    at head boundaries: `mp` must divide the KV heads.  With `train`, an
    untied `lm_head` must be a 1/mp column shard too (its logits are gathered
    whole for the cross-entropy), and int4 layouts are refused at any mp
    (training is fp32 or bf16)."""
    dec = cfg.decoder
    hd = dec.head_dim
    ffn_head = int(cfg.diffusion_head.hidden_size * cfg.diffusion_head.head_ffn_ratio)
    if dec.num_key_value_heads % mp:
        raise ValueError(f"TP degree {mp} must divide num_key_value_heads "
                         f"{dec.num_key_value_heads}; use a smaller model axis")

    def need(got, want, what):
        if got != want:
            raise ValueError(f"{what} has width {got}, but a shard over {mp} model rank(s) "
                             f"has {want}: pass this rank's `parallel.shard_params` shard")

    for i, lp in enumerate(params["lm"]["layers"]):
        if "qkv" in lp or "gateup" in lp:
            if mp > 1 or train:
                raise ValueError("int4's fused qkv/gateup layout is not TP-adaptable; "
                                 "quantize with mode='int8' for tensor parallelism")
            continue
        for name, heads in (("q", dec.num_attention_heads), ("k", dec.num_key_value_heads),
                            ("v", dec.num_key_value_heads)):
            need(_out_width(lp[name]["w"]), heads * hd // mp, f"layer {i} {name}")
        need(_in_width(lp["o"]["w"]), dec.num_attention_heads * hd // mp, f"layer {i} o")
        for name in ("gate", "up"):
            need(_out_width(lp[name]), dec.intermediate_size // mp, f"layer {i} {name}")
        need(_in_width(lp["down"]), dec.intermediate_size // mp, f"layer {i} down")
    for i, lp in enumerate(params["diffusion_head"]["layers"]):
        if "gateup" in lp or lp.get("gate") is None:  # int4 layouts, the head kernel's pack
            if mp > 1 or train:
                raise ValueError("an int4 diffusion head is not TP-adaptable")
            continue
        need(_out_width(lp["gate"]), ffn_head // mp, f"head layer {i} gate")
        need(_in_width(lp["down"]), ffn_head // mp, f"head layer {i} down")
    if train and params.get("lm_head") is not None:
        if dec.vocab_size % mp:
            raise ValueError(f"lm_head's {dec.vocab_size} columns do not split over {mp} "
                             "model ranks")
        need(_out_width(params["lm_head"]), dec.vocab_size // mp, "lm_head")


def split_dims(params, specs, axis: str = "model") -> List[Optional[int]]:
    """For each floating tensor leaf of `params`, in the JAX tree's flattening
    order (dict keys sorted, None skipped: the order of `train.trainable`),
    the dimension its spec splits over `axis`, or None for a leaf that is
    whole on every rank of the axis."""
    out: List[Optional[int]] = []

    def walk(x, spec):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], spec.get(k) if isinstance(spec, dict) else ())
            return
        if isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, spec[i] if isinstance(spec, list) else ())
            return
        if torch.is_tensor(x) and x.is_floating_point():
            names = spec if isinstance(spec, tuple) else ()
            out.append(names.index(axis) if axis in names else None)

    walk(params, specs)
    return out


def batch_specs() -> Dict[str, tuple]:
    """Input specs: the utterance batch over the data axis."""
    return {
        "input_ids": ("data", None),
        "attention_mask": ("data", None),
        "speech_input_mask": ("data", None),
        "speech_tensors": ("data", None),
        "speech_masks": ("data", None),
        "labels": ("data", None),
    }


__all__ = ["Mesh", "make_mesh", "model_param_specs", "qwen2_param_specs",
           "adapt_specs_to_quantized", "shard_params", "check_shard_shapes", "split_dims",
           "batch_specs"]
