"""Parallelism over `torch.distributed`: the mesh and its sharding rules, the
multi-process helpers, context-parallel and ring prefill attention."""
from .mesh import (  # noqa: F401
    Mesh,
    adapt_specs_to_quantized,
    batch_specs,
    check_shard_shapes,
    make_mesh,
    model_param_specs,
    qwen2_param_specs,
    shard_params,
    split_dims,
)
