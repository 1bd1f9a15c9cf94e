"""The port's int4 matmul (`ops/int4_matmul.py`) against the JAX package's, as
tests/test_int4_matmul.py checks the JAX kernel: pack order, the materialized
dequantization, and the matmul per channel and per group (the JAX kernel in
interpret mode on the CPU, the port's plain version), plus `quantize.mm`'s
route by row count."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.ops import int4_matmul as JI
from vibevoice_tpu.utils import quantize as JQ
from vibevoice_tpu_torch.ops import int4_matmul as TI
from vibevoice_tpu_torch.utils import quantize as TQ


def test_pack_order_matches_jax():
    """Byte row i = (low nibble: row 2i, high nibble: row 2i+1), signed."""
    q = np.clip(np.arange(-8, 8).repeat(4).reshape(16, 4), -8, 7)
    got = TI.pack_int4(torch.tensor(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JI.pack_int4(q)))
    np.testing.assert_array_equal(TI.unpack_int4(torch.tensor(got)).numpy(), q)


@pytest.mark.parametrize("group_size", [None, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_matches_jax(group_size, dtype):
    w = np.random.default_rng(2).normal(0, 0.02, (128, 96)).astype(np.float32)
    jq = JI.quantize_int4(w, group_size=group_size)
    tq = TI.quantize_int4(torch.tensor(w), group_size=group_size)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JI.dequant_int4_xla(jq["qint4"], jq["scale4"], jdt).astype(jnp.float32))
    got = TI.dequant_int4(tq["qint4"], tq["scale4"], dtype).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group_size", [None, 64])
@pytest.mark.parametrize("m,k,n", [(2, 256, 384), (5, 512, 300), (1, 64, 4)])
def test_int4_matmul_matches_jax(group_size, m, k, n):
    """fp32: the same int4 values, scales applied in the same order; only the
    summation order differs."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jq = JI.quantize_int4(w, group_size=group_size)
    tq = TI.quantize_int4(torch.tensor(w), group_size=group_size)
    want = np.asarray(JI.int4_matmul(jnp.asarray(x), jq["qint4"], jq["scale4"],
                                     n_blk=128, interpret=True))
    got = TI.int4_matmul(torch.tensor(x), tq["qint4"], tq["scale4"]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_bf16_rounding_order_matches_jax():
    """bf16 x: per channel the fp32 sum is scaled then cast; per group each
    weight is scaled in bf16 before the dot, as in the JAX kernel."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.02, (256, 128)).astype(np.float32)
    x = rng.normal(0, 1, (2, 256)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.tensor(x).to(torch.bfloat16)
    for gs in (None, 32):
        jq = JI.quantize_int4(w, group_size=gs)
        tq = TI.quantize_int4(torch.tensor(w), group_size=gs)
        want = np.asarray(JI.int4_matmul(xj, jq["qint4"], jq["scale4"], interpret=True)
                          .astype(jnp.float32))
        got = TI.int4_matmul(xt, tq["qint4"], tq["scale4"]).float().numpy()
        # one bf16 rounding step of the output (|y| < 4: 2^-6) at most
        np.testing.assert_allclose(got, want, atol=2 ** -6, rtol=0)


@pytest.mark.parametrize("lead", [(2, 1), (2, 64), (3, 100)])
def test_mm_routes_by_rows_like_jax(lead):
    """At most 128 rows take the kernel's route, more the dequantized matmul
    (the prefill route); both agree with the JAX package's `mm`."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.02, (64, 96)).astype(np.float32)
    x = rng.normal(0, 1, (*lead, 64)).astype(np.float32)
    jw = JQ.quantize_weight_int4(w)
    tw = TQ.quantize_weight_int4(torch.tensor(w))
    want = np.asarray(JQ.mm(jnp.asarray(x), jw))
    before = TI.int4_matmul.launches
    got = TQ.mm(torch.tensor(x), tw).numpy()
    assert TI.int4_matmul.launches == before  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_plan_fills_the_card_and_fits_shared_memory():
    """The kernel's grid (128-column tiles x K splits x passes of 16 rows): at
    the 1.5B decode shapes (M=2) a CTA per SM or a full portable cluster of 8
    splits per tile; every split holds a byte row and whole k16 steps; and a
    pass's x slice (16 bf16 or 4 fp32 rows) fits the staging buffer."""
    for m, k, n in [(2, 1536, 2048), (2, 1536, 1536), (2, 1536, 17920), (2, 8960, 1536),
                    (1, 1536, 1000), (64, 1536, 1536), (128, 1536, 2048), (128, 8960, 1536),
                    (2, 1000, 96)]:
        kbr, ksplit = TI.plan(m, k, n, 132)
        ctas = -(-n // 128) * -(-m // 16) * ksplit
        assert kbr % 8 == 0 and (ksplit - 1) * kbr < k // 2 <= ksplit * kbr, (m, k, n)
        assert min(m, 16) * (2 * kbr + 8) * 2 <= 98304 and min(m, 4) * (2 * kbr + 4) * 4 <= 98304
        assert 1 <= ksplit <= 8
        if m <= 2 and k >= 1536:
            assert ctas >= 132 or ksplit == 8, (m, k, n, ctas)


@pytest.mark.parametrize("m,k,n", [(2, 18944, 3584), (128, 18944, 3584),
                                   (128, 16 * TI.max_kbr(128), 64), (5, 256, 96), (1, 64, 4)])
def test_plan_keeps_the_splits_in_one_cluster(m, k, n):
    """The splits of a column tile are one portable cluster of at most 8 CTAs,
    for the 7B model's down projection (K=18944) too, and at the largest K
    whose x slices fit 8 splits; a K that would need more refuses the plan."""
    kbr, ksplit = TI.plan(m, k, n, 132)
    assert ksplit <= 8 and kbr <= TI.max_kbr(m)
    assert (ksplit - 1) * kbr < k // 2 <= ksplit * kbr
    with pytest.raises(ValueError, match="splits"):
        TI.plan(128, 16 * (TI.max_kbr(128) + 8), 64, 132)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x = torch.zeros((2, 6))
    q = TI.quantize_int4(torch.zeros((6, 8)))
    with pytest.raises(ValueError, match="rows"):
        TI._check(torch.zeros((129, 6)), q["qint4"], q["scale4"])
    with pytest.raises(ValueError, match="do not fit"):
        TI._check(torch.zeros((2, 8)), q["qint4"], q["scale4"])
    with pytest.raises(TypeError):
        TI._check(x.double(), q["qint4"], q["scale4"])
    with pytest.raises(ValueError, match="even"):
        TI.quantize_int4(torch.zeros((6, 8)), group_size=3)
