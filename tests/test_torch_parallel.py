"""The port's mesh, sharding rules, multi-process helpers, and context-parallel
and ring prefill (`vibevoice_tpu_torch.parallel`) against the JAX package's
(`vibevoice_tpu.parallel` on the virtual 8-device CPU mesh).

* The spec trees equal the JAX ones; int4's fused layout is refused alike.
* `shard_params` gives each rank (d, m) the JAX shard on device (d, m)
  (`addressable_shards`), bit for bit: fp32 with an untied head, bf16, and
  the int8 tree (its scales follow the output axis).
* `global_mesh`, `shard_batch_for_host` and `dp_scaling_report` in one
  process and on 2 gloo ranks, as `tests/test_multihost.py` holds the JAX
  ones.
* CP and ring prefill on 4 gloo ranks against `cp_prefill_attention(...,
  use_flash=False)` and `ring_prefill_attention` on `make_mesh(data=4)`, with
  the inputs of `tests/test_context_parallel.py` made with numpy: atol 2e-5,
  rtol 1e-4, left-padded rows compared on their real rows.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec

from vibevoice_tpu.parallel import context_parallel as JCP
from vibevoice_tpu.parallel import mesh as JM
from vibevoice_tpu.parallel import multihost as JMH
from vibevoice_tpu.parallel.ring_attention import ring_prefill_attention as j_ring
from vibevoice_tpu.utils.quantize import quantize_model
from vibevoice_tpu_torch.parallel import mesh as TM
from vibevoice_tpu_torch.parallel import multihost as TMH
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests._torch_ranks import Ranks, cp_ring_program, multihost_program, save_tree


def _spec_tree(tree):
    """A JAX spec tree with each PartitionSpec as the port's tuple."""
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    return tree


def _trees():
    """(name, JAX tree): fp32 with an untied lm_head, bf16, int8."""
    cfg, jp = tiny_params(0)
    head = np.random.default_rng(3).normal(
        size=(cfg.decoder.hidden_size, cfg.decoder.vocab_size)).astype(np.float32) * 0.02
    untied = dict(jp, lm_head=jnp.asarray(head))
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    int8 = quantize_model(jp, cfg.decoder.tie_word_embeddings, mode="int8")
    return cfg, [("fp32_untied", untied), ("bf16", bf16), ("int8", int8)]


@pytest.mark.parametrize("which", ["fp32_untied", "bf16", "int8"])
def test_spec_trees_equal_jax(which):
    cfg, trees = _trees()
    jp = dict(trees)[which]
    tp = from_jax(to_np(jp), device="cpu")
    assert TM.qwen2_param_specs(3) == _spec_tree(JM.qwen2_param_specs(3))
    want = JM.adapt_specs_to_quantized(jp, JM.model_param_specs(jp, cfg))
    got = TM.adapt_specs_to_quantized(tp, TM.model_param_specs(tp, cfg))
    assert got == _spec_tree(want)
    assert TM.batch_specs() == _spec_tree(JM.batch_specs())


def test_adapt_specs_rejects_int4_fused_layout():
    """int4's fused qkv/gateup layout is refused with the JAX package's type."""
    from vibevoice_tpu_torch.utils.quantize import quantize_model as t_quantize
    cfg, jp = tiny_params(0)
    jq = quantize_model(jp, cfg.decoder.tie_word_embeddings, mode="int4")
    with pytest.raises(ValueError) as jerr:
        JM.adapt_specs_to_quantized(jq, JM.model_param_specs(jq, cfg))
    tq = t_quantize(from_jax(to_np(jp), device="cpu"), cfg.decoder.tie_word_embeddings,
                    mode="int4")
    with pytest.raises(jerr.type):
        TM.adapt_specs_to_quantized(tq, TM.model_param_specs(tq, cfg))
    mesh = TM.Mesh(1, 2, rank=0, groups={})
    with pytest.raises(ValueError):
        TM.shard_params(tq, mesh, cfg=cfg)


def _leaves(tree, path="p"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("which", ["fp32_untied", "bf16", "int8"])
@pytest.mark.parametrize("data,model", [(1, 2), (2, 1), (2, 2)])
def test_shard_params_equals_jax_shards(which, data, model):
    """Rank (d, m) of the port holds, leaf for leaf and bit for bit, the JAX
    shard on device (d, m) of the same mesh shape."""
    cfg, trees = _trees()
    jp = dict(trees)[which]
    jmesh = JM.make_mesh(data=data, model=model)
    jshard = JM.shard_params(jp, jmesh, cfg=cfg)
    tp = from_jax(to_np(jp), device="cpu")
    jleaves = dict(_leaves(jshard))
    split = 0
    for rank in range(data * model):
        mesh = TM.Mesh(data, model, rank=rank, groups={})
        dev = jmesh.devices[mesh.coords]
        got = dict(_leaves(TM.shard_params(tp, mesh, cfg=cfg)))
        assert set(got) == set(jleaves)
        for path, arr in jleaves.items():
            want = next(s.data for s in arr.addressable_shards if s.device == dev)
            t = got[path]
            t = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
                else t.numpy()
            np.testing.assert_array_equal(t, _bits(want), err_msg=path)
            split += t.shape != arr.shape
    assert (split > 0) == (model > 1)


def test_make_mesh_needs_the_ranks():
    """One process without a group is a 1 x 1 mesh; a larger one raises the
    JAX package's ValueError ('need n devices')."""
    assert TM.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        JM.make_mesh(data=16)
    with pytest.raises(ValueError, match="need 2"):
        TM.make_mesh(model=2)


def test_multihost_single_process():
    """As `tests/test_multihost.py` holds the JAX helpers in one process."""
    assert TMH.global_mesh(model_parallel=1).shape == {"data": 1, "model": 1}
    x = np.ones((8, 5), np.float32)
    batch = TMH.shard_batch_for_host({"x": x, "y": None}, TMH.global_mesh())
    assert batch["y"] is None and batch["x"].shape == (8, 5)
    assert TMH.dp_scaling_report(12.0, 3.0) == JMH.dp_scaling_report(12.0, 3.0)
    with pytest.raises(ValueError):
        TMH.global_mesh(model_parallel=2)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """One spawn of 4 ranks (CP and ring) and one of 2 (multihost), started
    before the JAX references are made."""
    work = tmp_path_factory.mktemp("parallel")
    inputs = {}
    for case, seed, pad_row, pad in (("cp", 0, 0, 5), ("ring", 1, 1, 9)):
        rng = np.random.default_rng(seed)
        b, t, h, kvh, d = 2, 64, 4, 2, 32
        q = (rng.normal(size=(b, t, h, d)) * 0.3).astype(np.float32)
        k = (rng.normal(size=(b, t, kvh, d)) * 0.3).astype(np.float32)
        v = (rng.normal(size=(b, t, kvh, d)) * 0.3).astype(np.float32)
        m = np.ones((b, t), np.int32)
        m[pad_row, :pad] = 0
        inputs[case] = (q, k, v, m)
        save_tree(work / f"{case}.npz", list(inputs[case]))
    cp_ring = Ranks(cp_ring_program, 4, work, str(work), timeout=180)
    multi = Ranks(multihost_program, 2, work, timeout=120)
    mesh = JM.make_mesh(data=4, model=1)
    jax_cp = np.asarray(JCP.cp_prefill_attention(*map(jnp.asarray, inputs["cp"]), mesh,
                                                 axis="data", use_flash=False))
    jax_ring = np.asarray(j_ring(*map(jnp.asarray, inputs["ring"]), mesh, axis="data"))
    return dict(cp_ring=cp_ring.results(), multi=multi.results(), jax_cp=jax_cp,
                jax_ring=jax_ring)


def _assert_real_rows(got, want, pad_row, pad):
    for b in range(got.shape[0]):
        start = pad if b == pad_row else 0
        np.testing.assert_allclose(got[b, start:], want[b, start:], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("path", ["cp_dense", "cp_flash"])
def test_cp_prefill_matches_jax(ranked, path):
    """Each rank's 16 query rows attend the gathered 64 keys with their
    global offset; the rows, in rank order, equal the JAX CP output (the
    dense path, and the flash prefill wrapper's plain version).  One
    all-gather a call."""
    got = np.concatenate([r[path] for r in ranked["cp_ring"]], axis=1)
    _assert_real_rows(got, ranked["jax_cp"], 0, 5)
    for r in ranked["cp_ring"]:
        assert set(r["cp_counts"]) == {"all_gather"} and len(r["cp_counts"]["all_gather"]) == 2


def test_ring_prefill_matches_jax(ranked):
    """Ring attention over 4 ranks: 3 exchanges with the neighbour (one
    all_to_all_single each, K, V and the pad packed), and the JAX ring's
    output on the real rows."""
    got = np.concatenate([r["ring"] for r in ranked["cp_ring"]], axis=1)
    _assert_real_rows(got, ranked["jax_ring"], 1, 9)
    for r in ranked["cp_ring"]:
        assert set(r["ring_counts"]) == {"all_to_all_single"}
        assert len(r["ring_counts"]["all_to_all_single"]) == 3


def test_multihost_on_two_ranks(ranked):
    """`global_mesh` lays the ranks out as `make_mesh` does, each rank's
    `shard_batch_for_host` rows are its part of the batch in order, and
    `dp_scaling_report` sums the audio and takes the slowest wall."""
    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    for r, out in enumerate(ranked["multi"]):
        assert out["tp_shape"] == {"data": 1, "model": 2} and out["tp_coords"] == (0, r)
        assert out["dp_shape"] == {"data": 2, "model": 1} and out["dp_coords"] == (r, 0)
        np.testing.assert_array_equal(out["x"], x[4 * r:4 * r + 4])
        assert out["y"] is None
        assert out["report"] == {"hosts": 2, "audio_sec_total": 18.0, "throughput": 4.5}
