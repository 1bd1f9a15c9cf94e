"""The port's decode attention against the JAX Pallas kernel (interpret mode on
the CPU), and the CUDA path's argument checks.  The kernel itself is held
against its plain version on a card in `test_torch_cuda.py`."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.ops import decode_attention as jda
from vibevoice_tpu_torch.ops import decode_attention as tda


def _inputs(s, h, kvh, d, lengths, holes, quant, seed=0, n_layers=3):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(n_layers, b, s, kvh * d)).astype(np.float32)
    v = rng.normal(size=(n_layers, b, s, kvh * d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    vis = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    for r, slot in holes:  # holes like those a negative-stream reset leaves
        vis[r, slot] = 0
    if not quant:
        return q, k, v, vis, lengths, None, None
    # per-slot symmetric int8 with bf16-rounded scales (qwen2._quantize_slots)
    amax = np.abs(k).max(-1, keepdims=True)
    ks = np.asarray(jnp.asarray(amax / 127.0).astype(jnp.bfloat16).astype(jnp.float32))
    kq = np.clip(np.round(k / np.maximum(ks, 1e-12)), -127, 127).astype(np.int8)
    vamax = np.abs(v).max(-1, keepdims=True)
    vs = np.asarray(jnp.asarray(vamax / 127.0).astype(jnp.bfloat16).astype(jnp.float32))
    vq = np.clip(np.round(v / np.maximum(vs, 1e-12)), -127, 127).astype(np.int8)
    ksb = np.broadcast_to(ks[..., 0][:, :, None, :], (n_layers, b, 8, s))
    vsb = np.broadcast_to(vs[..., 0][:, :, None, :], (n_layers, b, 8, s))
    return q, kq, vq, vis, lengths, ksb, vsb


CASES = [
    # s, h, kvh, d, lengths, holes, quant
    (256, 4, 2, 64, [256, 256], [], False),
    (512, 8, 2, 64, [200, 500], [(0, 5), (1, 17), (1, 300)], False),
    (384, 4, 4, 64, [384, 129], [(1, 0)], False),
    (512, 12, 2, 128, [1, 400], [(1, 3)], False),
    (512, 12, 2, 64, [300, 512], [(0, 7), (1, 100)], True),
    (256, 8, 2, 128, [256, 77], [(0, 0), (1, 76)], True),
]


@pytest.mark.parametrize("s,h,kvh,d,lengths,holes,quant", CASES)
def test_decode_attention_ref_matches_jax(s, h, kvh, d, lengths, holes, quant):
    q, k, v, vis, ln, ks, vs = _inputs(s, h, kvh, d, lengths, holes, quant)
    layer = 1
    jk = dict(k_scale=jnp.asarray(ks, jnp.bfloat16), v_scale=jnp.asarray(vs, jnp.bfloat16)) \
        if quant else {}
    want = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           layer, jnp.asarray(vis), jnp.asarray(ln),
                                           block_k=128, **jk))
    tk = dict(k_scale=torch.tensor(ks).to(torch.bfloat16),
              v_scale=torch.tensor(vs).to(torch.bfloat16)) if quant else {}
    got = tda.decode_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v), layer,
                                   torch.tensor(vis), torch.tensor(ln), **tk).numpy()
    # fp32 cache: summation order only; int8: the same plus bf16 scale products
    np.testing.assert_allclose(got, want, atol=1e-4 if quant else 1e-5, rtol=0)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    q, k, v, vis, ln, _, _ = _inputs(256, 4, 2, 64, [100, 256], [(0, 3)], False)
    args = [torch.tensor(x) for x in (q, k, v)]
    before = tda.decode_attention.launches
    got = tda.decode_attention(*args, 2, torch.tensor(vis), torch.tensor(ln))
    want = tda.decode_attention_ref(*args, 2, torch.tensor(vis), torch.tensor(ln))
    assert torch.equal(got, want)
    assert tda.decode_attention.launches == before


def test_row_with_no_visible_slot_returns_zeros():
    q, k, v, vis, ln, _, _ = _inputs(128, 4, 2, 64, [50, 128], [], False)
    vis[0, :] = 0
    got = tda.decode_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0,
                                   torch.tensor(vis), torch.tensor(ln))
    assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[1]) > 0


@pytest.mark.parametrize("bad", ["visible_dtype", "cache_dtype", "layer", "scale_shape"])
def test_kernel_argument_checks(bad):
    """The CUDA path's checks, run on CPU tensors (they do not need a card)."""
    q, k, v, vis, ln, ks, vs = _inputs(128, 4, 2, 64, [128, 64], [], True)
    q = torch.tensor(q).to(torch.bfloat16)
    k, v, vis, ln = (torch.tensor(x) for x in (k, v, vis, ln))
    ks, vs = torch.tensor(ks).to(torch.bfloat16), torch.tensor(vs).to(torch.bfloat16)
    layer = 0
    if bad == "visible_dtype":
        vis = vis.bool()
    elif bad == "cache_dtype":
        k, v = k.float(), v.float()
    elif bad == "layer":
        layer = 3
    else:
        ks = ks[:, :, :4].contiguous()
    with pytest.raises((TypeError, ValueError)):
        tda._check(q, k, v, layer, vis, ln, ks, vs)


@pytest.mark.parametrize("b,kvh,s,dtype,kv,want", [
    (2, 2, 4096, torch.bfloat16, torch.bfloat16, 64),   # 1.5B engine, B=1: a split a tile
    (2, 2, 40960, torch.bfloat16, torch.bfloat16, 66),  # two CTAs per SM over 4 pairs
    (2, 2, 40960, torch.bfloat16, torch.int8, 99),      # int8 KV: three CTAs per SM
    (2, 4, 40960, torch.bfloat16, torch.bfloat16, 33),  # 7B grouping, KVH=4
    (1, 1, 100, torch.bfloat16, torch.int8, 2),         # never more splits than tiles
    (2, 2, 4096, torch.float32, torch.float32, 32),     # fp32: one 128-slot split per CTA
])
def test_plan_depends_on_shapes_only(b, kvh, s, dtype, kv, want):
    assert tda.plan(b, kvh, s, dtype, 132, kv) == want


@pytest.mark.parametrize("length", [0, 1, 63, 64, 340, 1500, 4096, 40000, 40960])
@pytest.mark.parametrize("n_splits", [1, 33, 66])
def test_splits_cover_the_live_prefix(length, n_splits):
    """The device's split rule: whole tiles, at most n_splits of them with
    work, covering every live slot; a short prefix still spreads (340 live
    slots: 6 CTAs per row and KV head)."""
    per, n_active = tda.split_of(length, n_splits, 40960)
    assert per % tda.TILE == 0 and 1 <= n_active <= n_splits
    assert n_active * per >= length and (n_active - 1) * per < max(length, 1)
    if n_splits == 66 and length == 340:
        assert n_active == 6


def test_workspace_is_cached_per_stream_and_shape():
    dev = torch.device("cpu")
    acc, ml, cnt = tda.workspace(dev, 7, 2, 2, 64, 6, 128)
    # 64 splits and their 8 groups of 8 for each of the 4 (row, KV head) pairs
    assert acc.shape == (4, 72, 6, 128) and ml.shape == (4, 72, 6, 2)
    assert acc.dtype == ml.dtype == torch.float32
    assert cnt.dtype == torch.int32 and cnt.shape == (4 * 9,) and not cnt.any()
    again = tda.workspace(dev, 7, 2, 2, 64, 6, 128)
    assert all(x is y for x, y in zip(again, (acc, ml, cnt)))
    assert tda.workspace(dev, 8, 2, 2, 64, 6, 128)[0] is not acc
    assert tda.workspace(dev, 7, 2, 4, 33, 7, 128)[0].shape == (8, 38, 7, 128)
