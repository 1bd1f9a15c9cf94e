"""Random weights from a seed, made on the device in a few large calls.

The tree and each leaf's distribution come from the reference's
`param_spec`; the benchmark hands the same tensors to the program and to the
reference.  All leaves are views into one buffer in the served type: one
`randn` per chunk of 2**30 elements, then one multiply-add per distinct
(mean, std), so the draw costs the same whatever the number of leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .reference.model import SPEECH_BIAS, SPEECH_SCALING, Leaf, param_spec

CHUNK = 1 << 30


def _leaves(tree, path=()) -> List[Tuple[tuple, Leaf]]:
    if isinstance(tree, Leaf):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return []


def _fill(tree, values: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, Leaf):
        return values[path]
    if isinstance(tree, dict):
        return {k: _fill(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, values, path + (i,)) for i, v in enumerate(tree)]
    return tree


def make_weights(cfg, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The whole parameter tree of `cfg` in `dtype` on `device`, from `seed`."""
    leaves = _leaves(param_spec(cfg))
    groups = sorted({(leaf.mean, leaf.std) for _, leaf in leaves})
    order = sorted(leaves, key=lambda pl: groups.index((pl[1].mean, pl[1].std)))
    total = sum(int(torch.Size(leaf.shape).numel()) for _, leaf in order)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for off in range(0, total, CHUNK):
        n = min(CHUNK, total - off)
        torch.randn(n, generator=gen, dtype=dtype, device=device, out=buf[off:off + n])
    values, off, spans = {}, 0, {}
    for path, leaf in order:
        n = int(torch.Size(leaf.shape).numel())
        values[path] = buf[off:off + n].view(leaf.shape)
        lo, hi = spans.get((leaf.mean, leaf.std), (off, off))
        spans[(leaf.mean, leaf.std)] = (min(lo, off), off + n)
        off += n
    for (mean, std), (lo, hi) in spans.items():
        buf[lo:hi].mul_(std).add_(mean)
    params = _fill(param_spec(cfg), values)
    params["speech_scaling_factor"] = torch.tensor(SPEECH_SCALING, device=device)
    params["speech_bias_factor"] = torch.tensor(SPEECH_BIAS, device=device)
    return params


__all__ = ["make_weights"]
