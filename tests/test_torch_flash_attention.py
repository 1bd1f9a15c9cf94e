"""The port's flash prefill (`ops/flash_attention.py`) against the JAX
package's, as tests/test_flash_attention.py checks the JAX kernel: the plain
version against the JAX Pallas kernel (interpret mode on the CPU, 128-row
blocks so that every case spans several query and key blocks) for GQA groups
of 2, 4 and 7 (the 7B model's), head dims 64 and 128, left pads of 0 and of a count that is not
a block multiple, and a query shard (T != S) at a `row_offset`."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.ops import flash_attention as JFA
from vibevoice_tpu_torch.ops import flash_attention as TFA

# (T, S, H, KVH, D, left pad of row 0, row_offset)
CASES = {
    "g2-d64": (320, 320, 4, 2, 64, 0, None),
    "g4-d128-pad77": (320, 320, 8, 2, 128, 77, None),
    "g2-d128-pad130": (200, 200, 4, 2, 128, 130, None),
    "g4-d64-shard": (136, 392, 4, 1, 64, 50, 256),
    "g7-d64-pad45": (200, 200, 14, 2, 64, 45, None),
}


def _inputs(case, seed):
    t, s, h, kvh, d, pad, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.normal(size=(2, t, h, d))).astype(np.float32)
    k = (0.5 * rng.normal(size=(2, s, kvh, d))).astype(np.float32)
    v = (0.5 * rng.normal(size=(2, s, kvh, d))).astype(np.float32)
    mask = np.ones((2, s), np.int32)
    mask[0, :pad] = 0
    return q, k, v, mask


def _real_rows(mask, t, row_offset):
    """Query rows that see at least one key: those whose own position is real."""
    return mask[:, (row_offset or 0) + np.arange(t)] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_matches_jax(case):
    """fp32: the real rows within the JAX test's own tolerance, every row
    finite, and the rows that see no key zero."""
    off = CASES[case][6]
    q, k, v, mask = _inputs(case, seed=len(case))
    want = np.asarray(JFA.flash_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), block_q=128,
        block_k=128, row_offset=off))
    before = TFA.flash_attention_prefill.launches
    got = TFA.flash_attention_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      torch.tensor(mask), row_offset=off).numpy()
    assert TFA.flash_attention_prefill.launches == before  # the CPU runs the plain version
    assert got.shape == q.shape and np.isfinite(got).all()
    real = _real_rows(mask, q.shape[1], off)
    np.testing.assert_allclose(got[real], want[real], atol=2e-5, rtol=1e-4)
    assert not got[~real].any()


def test_plain_flash_bf16_matches_jax():
    """bf16 operands: P rounded to bf16 before P.V on both sides, the TPU
    kernel per 128-key block against a running max, the plain version once
    per row: within two bf16 steps (2^-7) of the output's scale."""
    q, k, v, mask = _inputs("g4-d128-pad77", seed=3)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JFA.flash_attention_prefill(bf(q), bf(k), bf(v), jnp.asarray(mask),
                                                  block_q=128, block_k=128), np.float32)
    tb = lambda x: torch.tensor(x).to(torch.bfloat16)
    got = TFA.flash_attention_prefill(tb(q), tb(k), tb(v), torch.tensor(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    real = _real_rows(mask, q.shape[1], None)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[real], want[real], atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_non_causal_and_pairs():
    """causal=False spans every real key; `attended_pairs` counts the work a
    call needs, against a dense count."""
    q, k, v, mask = _inputs("g2-d64", seed=5)
    mask[1, :40] = 0
    want = np.asarray(JFA.flash_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal=False,
        block_q=128, block_k=128))
    got = TFA.flash_attention_prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      torch.tensor(mask), causal=False).numpy()
    real = _real_rows(mask, q.shape[1], None)
    np.testing.assert_allclose(got[real], want[real], atol=2e-5, rtol=1e-4)
    for case in CASES:
        t, s, _, _, _, pad, off = CASES[case]
        m = _inputs(case, 0)[3]
        rows = (off or 0) + np.arange(t)
        dense = (np.arange(s)[None, :] <= rows[:, None])[None] & (m[:, None, :] > 0)
        dense &= _real_rows(m, t, off)[:, :, None]
        assert TFA.attended_pairs(torch.tensor(m), t, row_offset=off) == int(dense.sum())


def test_kernel_refuses_what_it_does_not_take():
    """Shape and dtype checks run before any launch (here on the CPU, where
    no kernel can launch)."""
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    mask = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        TFA._check(q, kv, kv, mask)
    q, kv = torch.zeros(1, 8, 4, 128), torch.zeros(1, 8, 2, 128)
    with pytest.raises(TypeError, match="share"):
        TFA._check(q.double(), kv.double(), kv.double(), mask)
    with pytest.raises(ValueError, match="do not fit"):
        TFA._check(torch.zeros(1, 8, 3, 128), kv, kv, mask)
    with pytest.raises(ValueError, match="contiguous"):
        TFA._check(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv, mask)
    TFA._check(q, kv, kv, mask)
    with pytest.raises(ValueError, match="cuda or cpu"):
        TFA.flash_attention_prefill(q.to("meta"), kv.to("meta"), kv.to("meta"), mask.to("meta"))


@pytest.mark.parametrize("b,t,h,kvh,rows", [(1, 1024, 12, 2, 64), (1, 512, 12, 2, 64),
                                            (1, 4096, 12, 2, 128), (2, 1024, 12, 2, 128),
                                            (1, 1000, 28, 4, 128), (1, 4096, 28, 4, 128)])
def test_cta_rows_give_every_sm_a_cta(b, t, h, kvh, rows):
    """The bf16 kernel's CTA height on a 132-SM card: 128 rows where 128-row
    tiles x KV heads x batch rows reach 132 CTAs, else 64 (twice the CTAs);
    the fixed-height entry takes the plain version on the CPU too."""
    assert TFA.cta_rows(b, t, h, kvh, 132) == rows
    tiles = -(-t * (h // kvh) // rows)
    assert tiles * kvh * b >= 132 or rows == 64
    q, k, v, mask = (torch.tensor(x) for x in _inputs("g7-d64-pad45", seed=1))
    before = TFA.flash_attention_prefill.launches
    got = TFA.flash_attention_prefill_at(q, k, v, mask, rows)
    assert TFA.flash_attention_prefill.launches == before
    torch.testing.assert_close(got, TFA.flash_attention_prefill_ref(q, k, v, mask))
