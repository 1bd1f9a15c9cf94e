"""Checkpoint import and export.

Import: HF-format VibeVoice checkpoints (safetensors shards in the
reference's names, the output of its converter
`vibevoice/scripts/convert_nnscaler_checkpoint_to_transformers.py:20-131`)
into the params tree.  The safetensors reader is the port's own: it maps the
file and hands out tensors that are views of the mapping, so a shard is read
from disk once, when its tensors are copied to the target device.  Export: the
port's native format, an `.npz` keyed by each leaf's tree path, or one
safetensors file (`save_safetensors`, the reader's inverse).

The PyTorch port's own copy of `vibevoice_tpu/utils/checkpoint.py`.
"""
from __future__ import annotations

import json
import mmap
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..configs import VibeVoiceConfig, config_from_json
from ..device import resolve_device

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype); bf16 is
# stored as int16 bits (numpy has no bf16) and viewed as torch.bfloat16
_DTYPES = {
    "F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16), "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one safetensors file.  Each tensor is a view of
    a private (copy-on-write) mapping of the file, which stays mapped while
    any view lives; nothing is read until a view is.  Raises ValueError on a
    header that runs past the file, an unknown dtype, or data offsets that
    fall outside the data or overlap."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, shorter than the header length field")
        (n,) = np.frombuffer(f.read(8), "<u8")
        if 8 + int(n) > size:
            raise ValueError(f"{path}: the header ({int(n)} bytes) runs past the file "
                             f"({size} bytes)")
        header = json.loads(f.read(int(n)))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start, data_len = 8 + int(n), size - 8 - int(n)
    spans, out = [], {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {info['dtype']!r}")
        np_dt, torch_dt = _DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= data_len or end - begin != count * np.dtype(np_dt).itemsize:
            raise ValueError(f"{path}: tensor {name!r} has data offsets [{begin}, {end}) that "
                             f"do not hold {info['dtype']}{shape} within the {data_len} "
                             "data bytes")
        spans.append((begin, end, name))
        a = np.frombuffer(buf, np_dt, count, start + begin).reshape(shape)
        if not a.flags.aligned:
            a = a.copy()
        out[name] = torch.from_numpy(a).view(torch_dt)
    spans.sort()
    for (_, end, prev), (begin, _, name) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: tensors {prev!r} and {name!r} overlap")
    return out


_NAMES = {torch_dt: name for name, (_, torch_dt) in _DTYPES.items()}


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> int:
    """Write {name: tensor} as one safetensors file, the inverse of
    `read_safetensors`: an 8-byte little-endian header length, the JSON
    header (padded with spaces to 8 bytes), then each tensor's bytes in
    order.  Returns the file's size."""
    import struct
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)
    return 8 + len(h) + off


# ---------------------------------------------------------------------------
# flat reference names -> the params tree (the JAX package's `params_from_flat`)
# ---------------------------------------------------------------------------

def _conv_w(a):   # [Cout, Cin, K] -> [K, Cin, Cout]
    return a.permute(2, 1, 0).contiguous()


def _convt_w(a):  # [Cin, Cout, K] -> [Cin, K, Cout]
    return a.permute(0, 2, 1).contiguous()


def _lin_w(a):    # [out, in] -> [in, out]
    return a.t().contiguous()


def _opt(sd, name):
    return sd[name] if name in sd else None


def _block(sd, base):
    return {
        "norm_w": sd[f"{base}.norm.weight"],
        "mixer": {"w": _conv_w(sd[f"{base}.mixer.conv.conv.conv.weight"]),
                  "b": _opt(sd, f"{base}.mixer.conv.conv.conv.bias")},
        "gamma": sd[f"{base}.gamma"],
        "ffn_norm_w": sd[f"{base}.ffn_norm.weight"],
        "ffn1": {"w": _lin_w(sd[f"{base}.ffn.linear1.weight"]),
                 "b": _opt(sd, f"{base}.ffn.linear1.bias")},
        "ffn2": {"w": _lin_w(sd[f"{base}.ffn.linear2.weight"]),
                 "b": _opt(sd, f"{base}.ffn.linear2.bias")},
        "ffn_gamma": sd[f"{base}.ffn_gamma"],
    }


def _wb(sd, name, fn=_conv_w):
    """{"w": the weight in our layout, "b": the bias or None}."""
    return {"w": fn(sd[f"{name}.weight"]), "b": _opt(sd, f"{name}.bias")}


def _stages(sd, prefix, depths):
    return [[_block(sd, f"{prefix}.stages.{i}.{j}") for j in range(d)]
            for i, d in enumerate(depths)]


def _tok_encoder_from_flat(sd, prefix: str, depths) -> Dict[str, Any]:
    return {"down": [_wb(sd, f"{prefix}.downsample_layers.{i}.0.conv.conv")
                     for i in range(len(depths))],
            "stages": _stages(sd, prefix, depths),
            "final_norm_w": _opt(sd, f"{prefix}.norm.weight"),
            "head": _wb(sd, f"{prefix}.head.conv.conv")}


def _tok_decoder_from_flat(sd, prefix: str, depths) -> Dict[str, Any]:
    # the first upsample layer is a conv, the rest are transposed convs
    up = [_wb(sd, f"{prefix}.upsample_layers.0.0.conv.conv")]
    up += [_wb(sd, f"{prefix}.upsample_layers.{i}.0.convtr.convtr", _convt_w)
           for i in range(1, len(depths))]
    return {"up": up, "stages": _stages(sd, prefix, depths),
            "final_norm_w": _opt(sd, f"{prefix}.norm.weight"),
            "head": _wb(sd, f"{prefix}.head.conv.conv")}


def _connector_from_flat(sd, prefix: str) -> Dict[str, Any]:
    return {"fc1": {"w": _lin_w(sd[f"{prefix}.fc1.weight"]), "b": sd[f"{prefix}.fc1.bias"]},
            "norm_w": sd[f"{prefix}.norm.weight"],
            "fc2": {"w": _lin_w(sd[f"{prefix}.fc2.weight"]), "b": sd[f"{prefix}.fc2.bias"]}}


def params_from_flat(sd: Mapping[str, torch.Tensor], cfg: VibeVoiceConfig) -> Dict[str, Any]:
    """Flat HF state dict (torch tensors in the reference's names and
    layouts) -> params tree: linear weights transposed to [in, out], convs to
    [K, Cin, Cout], transposed convs to [Cin, K, Cout]; absent biases, final
    norms and speech factors (NaN) as the JAX package leaves them; `lm_head`
    only when present and not tied.  The tensors stay on their device."""
    lm = "model.language_model"
    layers = []
    for i in range(cfg.decoder.num_hidden_layers):
        b = f"{lm}.layers.{i}"
        layers.append({
            "input_norm_w": sd[f"{b}.input_layernorm.weight"],
            "q": _wb(sd, f"{b}.self_attn.q_proj", _lin_w),
            "k": _wb(sd, f"{b}.self_attn.k_proj", _lin_w),
            "v": _wb(sd, f"{b}.self_attn.v_proj", _lin_w),
            "o": {"w": _lin_w(sd[f"{b}.self_attn.o_proj.weight"]), "b": None},
            "post_norm_w": sd[f"{b}.post_attention_layernorm.weight"],
            "gate": _lin_w(sd[f"{b}.mlp.gate_proj.weight"]),
            "up": _lin_w(sd[f"{b}.mlp.up_proj.weight"]),
            "down": _lin_w(sd[f"{b}.mlp.down_proj.weight"]),
        })
    head = "model.prediction_head"
    nan = torch.tensor(float("nan"))
    return {
        "lm": {"embed": sd[f"{lm}.embed_tokens.weight"], "layers": layers,
               "final_norm_w": sd[f"{lm}.norm.weight"]},
        "acoustic_encoder": _tok_encoder_from_flat(
            sd, "model.acoustic_tokenizer.encoder", cfg.acoustic_tokenizer.encoder_depths),
        "acoustic_decoder": _tok_decoder_from_flat(
            sd, "model.acoustic_tokenizer.decoder",
            cfg.acoustic_tokenizer.decoder_depths_resolved()),
        "semantic_encoder": _tok_encoder_from_flat(
            sd, "model.semantic_tokenizer.encoder", cfg.semantic_tokenizer.encoder_depths),
        "acoustic_connector": _connector_from_flat(sd, "model.acoustic_connector"),
        "semantic_connector": _connector_from_flat(sd, "model.semantic_connector"),
        "diffusion_head": {
            "noisy_proj": _lin_w(sd[f"{head}.noisy_images_proj.weight"]),
            "cond_proj": _lin_w(sd[f"{head}.cond_proj.weight"]),
            "t_mlp1": _lin_w(sd[f"{head}.t_embedder.mlp.0.weight"]),
            "t_mlp2": _lin_w(sd[f"{head}.t_embedder.mlp.2.weight"]),
            "layers": [{
                "ada_w": _lin_w(sd[f"{head}.layers.{i}.adaLN_modulation.1.weight"]),
                "norm_w": sd[f"{head}.layers.{i}.norm.weight"],
                "gate": _lin_w(sd[f"{head}.layers.{i}.ffn.gate_proj.weight"]),
                "up": _lin_w(sd[f"{head}.layers.{i}.ffn.up_proj.weight"]),
                "down": _lin_w(sd[f"{head}.layers.{i}.ffn.down_proj.weight"]),
            } for i in range(cfg.diffusion_head.head_layers)],
            "final_ada_w": _lin_w(sd[f"{head}.final_layer.adaLN_modulation.1.weight"]),
            "final_linear": _lin_w(sd[f"{head}.final_layer.linear.weight"]),
        },
        "speech_scaling_factor": sd.get("model.speech_scaling_factor", nan),
        "speech_bias_factor": sd.get("model.speech_bias_factor", nan),
        "lm_head": (_lin_w(sd["lm_head.weight"])
                    if "lm_head.weight" in sd and not cfg.decoder.tie_word_embeddings
                    else None),
    }


class _OnDevice(Mapping):
    """A flat state dict whose tensors are copied to `device` as they are
    read: each mapped tensor crosses once, and its transposed form is made
    on the device."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd, self.device = sd, device

    def __getitem__(self, name):
        return self.sd[name].to(self.device, copy=True)

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def load_hf_checkpoint(model_path: str, cfg: Optional[VibeVoiceConfig] = None,
                       dtype: Optional[torch.dtype] = None, device="cuda"):
    """An HF-format VibeVoice checkpoint directory -> (params tree on
    `device`, config).  Reads the shards of `model.safetensors.index.json`,
    or `model.safetensors`; the config from `config.json` unless given.
    `dtype` recasts the floating leaves."""
    device = resolve_device(device)
    if cfg is None:
        cfg = config_from_json(os.path.join(model_path, "config.json"))
    index_path = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    elif os.path.exists(os.path.join(model_path, "model.safetensors")):
        shards = ["model.safetensors"]
    else:
        raise FileNotFoundError(f"no safetensors found under {model_path}")
    sd: Dict[str, torch.Tensor] = {}
    for shard in shards:
        sd.update(read_safetensors(os.path.join(model_path, shard)))
    params = params_from_flat(_OnDevice(sd, device), cfg)
    del sd  # the last views of the mappings: the shards are unmapped
    cast = lambda x: x.to(device, dtype if dtype is not None and x.is_floating_point()
                          else x.dtype)
    return _map_tree(cast, params), cfg


# ---------------------------------------------------------------------------
# native format: an .npz keyed by tree path
# ---------------------------------------------------------------------------

def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save_native(params, path: str) -> str:
    """Save a params tree (dicts with str or int keys, lists, tuples, None
    and tensors) as an .npz: one entry per tensor keyed by its tree path
    ("lm/layers/0/q/w"), bf16 stored as its int16 bits, and the tree's
    skeleton as JSON under "__tree__".  Returns the file's path."""
    arrays: Dict[str, np.ndarray] = {}

    def skel(node, key):
        if node is None:
            return None
        if isinstance(node, dict):
            return {"dict": [[k, skel(v, f"{key}/{k}")] for k, v in node.items()]}
        if isinstance(node, (list, tuple)):
            return {type(node).__name__: [skel(v, f"{key}/{i}") for i, v in enumerate(node)]}
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"{key}: cannot save a {type(node).__name__} leaf")
        arrays[key] = _to_numpy(node)
        return {"leaf": key, "bf16": node.dtype == torch.bfloat16}

    tree = json.dumps(skel(params, ""))
    out = _npz_path(path)
    np.savez(out, __tree__=np.array(tree), **{k.lstrip("/"): v for k, v in arrays.items()})
    return out


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.array(a, order="C").view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _fill_jax_order(tree, arrays, device):
    """`tree` with its leaves replaced by `arrays` taken in the JAX
    package's flattening order (dict keys sorted, None an empty subtree);
    the JAX package's bf16 arrays load as 2-byte void (ml_dtypes')."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _fill_jax_order(tree[k], arrays, device) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill_jax_order(v, arrays, device) for v in tree)
    a = next(arrays)
    return _from_numpy(a, a.dtype.kind == "V" and a.dtype.itemsize == 2, device)


def load_native(path: str, like=None, device="cuda"):
    """Load a tree saved by `save_native` onto `device` (CUDA unless the
    caller asks for the CPU).  The JAX package's npz fallback (leaves
    `arr_0..` in its flattening order) needs `like`, a tree of the same
    structure, whose leaves it replaces."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as data:
        if "__tree__" in data.files:
            def build(node):
                if node is None:
                    return None
                if "dict" in node:
                    return {k: build(v) for k, v in node["dict"]}
                if "list" in node:
                    return [build(v) for v in node["list"]]
                if "tuple" in node:
                    return tuple(build(v) for v in node["tuple"])
                return _from_numpy(data[node["leaf"].lstrip("/")], node["bf16"], device)
            return build(json.loads(str(data["__tree__"])))
        if like is None:
            raise ValueError("the JAX package's npz needs a `like` tree for its structure")
        arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
    n_leaves = len([x for x in _leaves(like) if x is not None])
    if len(arrays) != n_leaves:
        raise ValueError(f"checkpoint has {len(arrays)} leaves, the tree {n_leaves}")
    return _fill_jax_order(like, iter(arrays), device)


__all__ = ["read_safetensors", "save_safetensors", "params_from_flat", "load_hf_checkpoint",
           "save_native", "load_native"]
