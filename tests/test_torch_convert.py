"""`vibevoice_tpu_torch/scripts/convert_nnscaler_checkpoint.py` against the
JAX script on a `torch.save`d fake nnscaler checkpoint of the tiny model
(the `model.model.` prefix, a non-tensor entry, one file or `model_part-*`
shards, a tied, untied or missing `lm_head`): the trees bit-equal."""
import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from vibevoice_tpu.utils import checkpoint as jckpt
from vibevoice_tpu_torch import weights
from vibevoice_tpu_torch.scripts import convert_nnscaler_checkpoint as TCONV
from vibevoice_tpu_torch.utils import checkpoint as tckpt

from tests.test_torch_checkpoint import (_jax_tree, assert_trees_bit_equal, flat_from_params,
                                         hf_config)

_SPEC = importlib.util.spec_from_file_location(
    "jax_convert_nnscaler_checkpoint",
    os.path.join(os.path.dirname(__file__), "..", "scripts", "convert_nnscaler_checkpoint.py"))
JCONV = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JCONV)

# (tied, lm_head in the checkpoint, shards)
CASES = {"tied-one-file": (True, False, 1), "tied-shards": (True, False, 3),
         "untied-shards": (False, True, 2), "untied-missing-head": (False, False, 1)}


def _write(tmp_path, case):
    tied, head, shards = CASES[case]
    p, cfg = _jax_tree(tied=tied)
    flat = flat_from_params(p)
    if not head:
        flat.pop("lm_head.weight", None)
    # nnscaler wraps the model once more: model.* -> model.model.*
    state = {("model." + k if k.startswith("model.") else k): torch.from_numpy(v)
             for k, v in flat.items()}
    names = sorted(state)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    if shards == 1:
        path = ckpt / "checkpoint.pt"
        torch.save({"model": dict(state, step=7)}, path)
    else:
        path = ckpt
        for s in range(shards):
            part = {k: state[k] for k in names[s::shards]}
            torch.save({"state_dict": part, "epoch": 1}, ckpt / f"rank0_model_part-{s}.pt")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(hf_config(cfg)))
    return str(path), str(cfg_path), cfg


def _jax_params(path, cfg):
    sd = JCONV.load_nnscaler_state(path)
    if "lm_head.weight" not in sd and not cfg.decoder.tie_word_embeddings:
        sd["lm_head.weight"] = sd["model.language_model.embed_tokens.weight"]
    want = jckpt.params_from_flat(sd, cfg)
    return weights.from_jax(jax.tree_util.tree_map(np.asarray, want), device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_conversion_matches_jax(tmp_path, case):
    path, cfg_path, cfg = _write(tmp_path, case)
    want = _jax_params(path, cfg)
    sd = TCONV.load_nnscaler_state(path)
    assert sorted(sd) == sorted(JCONV.load_nnscaler_state(path))
    assert all(k.startswith(("model.", "lm_head.")) and not k.startswith("model.model.")
               for k in sd)
    out = tmp_path / "out"
    got = TCONV.main(["--checkpoint", path, "--config", cfg_path, "--output", str(out),
                      "--device", "cpu"])
    assert_trees_bit_equal(got, want)
    assert (got["lm_head"] is None) == cfg.decoder.tie_word_embeddings
    assert_trees_bit_equal(tckpt.load_native(str(out / "params"), device="cpu"), want)


@pytest.mark.parametrize("case", ["tied-shards", "untied-missing-head"])
def test_safetensors_conversion_matches_jax(tmp_path, case):
    """`--format safetensors`: the port's own writer, read back by its loader
    (and by the JAX loader), equal to the JAX conversion."""
    path, cfg_path, cfg = _write(tmp_path, case)
    want = _jax_params(path, cfg)
    out = tmp_path / "out"
    TCONV.main(["--checkpoint", path, "--config", cfg_path, "--output", str(out),
                "--format", "safetensors", "--device", "cpu"])
    got, tcfg = tckpt.load_hf_checkpoint(str(out), device="cpu")
    assert dataclasses.asdict(tcfg)["decoder"] == dataclasses.asdict(cfg)["decoder"]
    assert_trees_bit_equal(got, want)
    jgot, _ = jckpt.load_hf_checkpoint(str(out))
    assert_trees_bit_equal(weights.from_jax(jax.tree_util.tree_map(np.asarray, jgot),
                                            device="cpu"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8,
                                   torch.int64, torch.bool])
def test_safetensors_writer_round_trips(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    tensors = {"a": (torch.randn(3, 5, generator=gen) * 50).to(dtype),
               "b.c": (torch.randn(7, generator=gen) * 50).to(dtype)[::2],
               "scalar": torch.tensor(1, dtype=dtype)}
    n = tckpt.save_safetensors(tensors, str(tmp_path / "x.safetensors"))
    assert n == os.path.getsize(tmp_path / "x.safetensors")
    back = tckpt.read_safetensors(str(tmp_path / "x.safetensors"))
    assert list(back) == list(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == dtype and torch.equal(back[k], v), k
