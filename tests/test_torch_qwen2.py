"""The port's Qwen2 decoder against the JAX package: prefill into the stacked
cache, then decode steps over it (dense and kernel paths, fp32 and int8 KV)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vibevoice_tpu.configs import tiny_config
from vibevoice_tpu.models import norms as jnorms, qwen2 as jq
from vibevoice_tpu_torch.models import norms as tnorms, qwen2 as tq
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import to_np

CFG = tiny_config(vocab_size=320)
DEC = CFG.decoder


@pytest.fixture(scope="module")
def lm_params():
    p = jq.init(jax.random.PRNGKey(3), DEC)
    # non-zero q/k/v biases and norm weights so every parameter is exercised
    rng = np.random.default_rng(3)
    for lp in p["layers"]:
        for name in ("q", "k", "v"):
            lp[name]["b"] = jnp.asarray(rng.normal(size=lp[name]["b"].shape).astype(np.float32) * 0.1)
        lp["input_norm_w"] = jnp.asarray(1 + 0.1 * rng.normal(size=lp["input_norm_w"].shape).astype(np.float32))
    return p, from_jax(to_np(p), device="cpu")


def test_rms_norm_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tnorms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)  # fp32 sum order


def test_masks_and_positions_match_jax():
    mask = np.array([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]], np.int32)
    vis = np.array([[1, 0, 1, 1, 0, 0], [0, 0, 0, 1, 0, 1]], np.int32)
    tm = torch.tensor(mask)
    np.testing.assert_array_equal(tq.causal_bias(tm, 4).numpy(),
                                  np.asarray(jq.causal_bias(jnp.asarray(mask), 4)))
    np.testing.assert_array_equal(tq.decode_bias(torch.tensor(vis)).numpy(),
                                  np.asarray(jq.decode_bias(jnp.asarray(vis))))
    np.testing.assert_array_equal(tq.positions_from_mask(tm).numpy(),
                                  np.asarray(jq.positions_from_mask(jnp.asarray(mask))))


def test_rope_matches_jax():
    pos = np.array([[0, 1, 7, 300]], np.int32)
    jc, js = jq.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tc, ts = tq.rope_cos_sin(torch.tensor(pos), 16, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_quantize_slots_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 32)).astype(np.float32)
    jqv, jsc = jq._quantize_slots(jnp.asarray(x))
    tqv, tsc = tq._quantize_slots(torch.tensor(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.float().numpy(), np.asarray(jsc.astype(jnp.float32)))


def _cache_np(c):
    return [np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
            for x in c if x is not None]


def _cache_t(c):
    return [x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
            for x in c if x is not None]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_then_decode_matches_jax(lm_params, quant, kernel):
    """Left-padded prefill into rows [0:B), a one-slot pre-seed into rows
    [B:2B) (batch_offset), then decode steps over all 2B rows."""
    jp, tp = lm_params
    b, t0, s, h = 2, 10, 256, DEC.hidden_size
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, t0, h)).astype(np.float32)
    mask = np.ones((b, t0), np.int32)
    mask[1, :3] = 0

    jc = jq.kv_cache_init(DEC, 2 * b, s, quantized=quant)
    tc = tq.kv_cache_init(DEC, 2 * b, s, quantized=quant)
    bias = np.full((b, 1, t0, s), -1e9, np.float32)
    bias[..., :t0] = np.asarray(jq.causal_bias(jnp.asarray(mask), t0))
    pos = np.asarray(jq.positions_from_mask(jnp.asarray(mask)))
    jh, jc = jq.forward(jp, DEC, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(bias),
                        cache=jc, write_pos=jnp.int32(0))
    th, tc = tq.forward(tp, DEC, torch.tensor(x), torch.tensor(pos), torch.tensor(bias),
                        cache=tc, write_pos=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)

    xs = rng.normal(size=(b, 1, h)).astype(np.float32)
    nb = np.full((b, 1, 1, s), -1e9, np.float32)
    nb[..., 0] = 0
    zp = np.zeros((b, 1), np.int32)
    jh, jc = jq.forward(jp, DEC, jnp.asarray(xs), jnp.asarray(zp), jnp.asarray(nb),
                        cache=jc, write_pos=jnp.int32(0), batch_offset=b)
    th, tc = tq.forward(tp, DEC, torch.tensor(xs), torch.tensor(zp), torch.tensor(nb),
                        cache=tc, write_pos=0, batch_offset=b)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)

    vis = np.zeros((2 * b, s), np.int32)
    vis[:b, :t0] = mask
    vis[b:, 0] = 1
    for i in range(3):
        wp = t0 + i
        vis[:, wp] = 1
        xd = rng.normal(size=(2 * b, 1, h)).astype(np.float32)
        pd = np.concatenate([pos[:, -1:] + 1 + i, np.full((b, 1), 1 + i)]).astype(np.int32)
        ln = np.full((2 * b,), wp + 1, np.int32)
        jctx = (jnp.asarray(vis), jnp.asarray(ln)) if kernel else None
        tctx = (torch.tensor(vis), torch.tensor(ln)) if kernel else None
        db = np.asarray(jq.decode_bias(jnp.asarray(vis)))
        jh, jc = jq.forward(jp, DEC, jnp.asarray(xd), jnp.asarray(pd), jnp.asarray(db),
                            cache=jc, write_pos=jnp.int32(wp), decode_ctx=jctx)
        th, tc = tq.forward(tp, DEC, torch.tensor(xd), torch.tensor(pd),
                            None if kernel else torch.tensor(db),
                            cache=tc, write_pos=wp, decode_ctx=tctx)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    for a, w in zip(_cache_t(tc), _cache_np(jc)):
        np.testing.assert_allclose(a.astype(np.float32), w.astype(np.float32), atol=1e-4)

