"""The port's Block1D chains (`ops/fused_blocks.py`) against the JAX
package's, as tests/test_fused_blocks.py checks the JAX kernels (in interpret
mode on the CPU, against the port's plain versions): the int4 batched chain
for B in {1, 3} and T in {1, 5, 8}; the plain-pack chain (fp32 and bf16
packs, T in {1, 4, 8}) over two chunks with the context carried; and
decoder/encoder streaming with int4 and with plain packs over several
frames."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.models import tokenizer as jtok
from vibevoice_tpu.ops import fused_blocks as JFB
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import tokenizer as ttok
from vibevoice_tpu_torch.ops import fused_blocks as TFB
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests.test_torch_quantize import _assert_trees_equal

# The TPU kernel's rational erf (|err| < 1.5e-7) against the exact erf, and
# sums in another order: fp32 agreement to a few 1e-6 of the output's scale.
TOL = 2e-5


def _blocks(d, n, seed):
    rng = np.random.default_rng(seed)
    f = 4 * d
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return [{"norm_w": 1 + 0.1 * r(d), "mixer": {"w": 0.2 * r(7, 1, d), "b": 0.1 * r(d)},
             "gamma": 0.3 * r(d), "ffn_norm_w": 1 + 0.1 * r(d),
             "ffn1": {"w": 0.05 * r(d, f), "b": 0.1 * r(f)},
             "ffn2": {"w": 0.05 * r(f, d), "b": 0.1 * r(d)}, "ffn_gamma": 0.3 * r(d)}
            for _ in range(n)]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 5, 8])
def test_batched_chain_matches_jax(b, t):
    d, n = 16, 2
    blocks = _blocks(d, n, seed=10 * b + t)
    jpack = JFB.pack_stage_q([{k: (jnp.asarray(v) if not isinstance(v, dict) else
                                   {kk: jnp.asarray(vv) for kk, vv in v.items()})
                               for k, v in bp.items()} for bp in blocks])
    tpack = TFB.pack_stage_q(from_jax(blocks))
    _assert_trees_equal(tpack, jpack)
    rng = np.random.default_rng(b * t)
    x = (0.5 * rng.normal(size=(b, t, d))).astype(np.float32)
    ctx = (0.5 * rng.normal(size=(b, n, 6, d))).astype(np.float32)
    jy, jctx = JFB.fused_block_chain_batched(jpack, jnp.asarray(x), jnp.asarray(ctx))
    ty, tctx = TFB.fused_block_chain_batched(tpack, torch.tensor(x), torch.tensor(ctx))
    assert ty.shape == (b, t, d) and tctx.shape == (b, n, 6, d)
    scale = np.abs(np.asarray(jy)).max()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=TOL * scale, rtol=0)
    # one row at a time through the single-row entry point: the same numbers
    for r in range(b):
        y1, c1 = TFB.fused_block_chain(tpack, torch.tensor(x[r]), torch.tensor(ctx[r]))
        np.testing.assert_allclose(y1.numpy(), ty[r].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(c1.numpy(), tctx[r].numpy(), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def models():
    cfg, jp = tiny_params()
    return cfg, jp, from_jax(to_np(jp)), TC.tiny_config(vocab_size=320)


def test_decoder_streaming_with_int4_packs_matches_jax(models):
    """Four frames through the acoustic decoder with its T <= 8 stages on the
    chain (stages 0, 1, 2 of the tiny decoder)."""
    cfg, jp, tp, tcfg = models
    jpacks = jtok.pack_decoder_stages(jp["acoustic_decoder"], cfg.acoustic_tokenizer,
                                      quant="int4")
    tpacks = ttok.pack_decoder_stages(tp["acoustic_decoder"], tcfg.acoustic_tokenizer,
                                      quant="int4")
    assert set(tpacks) == set(jpacks) == {0, 1, 2}
    _assert_trees_equal(tpacks, jpacks)
    z = np.random.default_rng(14).normal(size=(2, 4, cfg.acoustic_vae_dim)).astype(np.float32)
    jst = jtok.decoder_state_init(cfg.acoustic_tokenizer, 2)
    tst = ttok.decoder_state_init(tcfg.acoustic_tokenizer, 2)
    for f in range(4):
        jy, jst = jtok.decoder_apply_streaming_fused(
            jp["acoustic_decoder"], cfg.acoustic_tokenizer, jnp.asarray(z[:, f:f + 1]), jst,
            fused_packs=jpacks)
        ty, tst = ttok.decoder_apply_streaming_fused(
            tp["acoustic_decoder"], tcfg.acoustic_tokenizer, torch.tensor(z[:, f:f + 1]), tst,
            fused_packs=tpacks)
        scale = np.abs(np.asarray(jy)).max()
        assert scale > 1e-2
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4 * scale, rtol=0)
    for js, ts in zip(jst, tst):  # the carried streaming states too
        np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), atol=1e-4, rtol=1e-4)


def test_encoder_streaming_with_int4_packs_matches_jax(models):
    """Three frames through the semantic encoder with its T <= 8 stages on the
    chain (stages 1, 2, 3 of the tiny encoder)."""
    cfg, jp, tp, tcfg = models
    hop = cfg.speech_compress_ratio
    jpacks = jtok.pack_encoder_stages(jp["semantic_encoder"], cfg.semantic_tokenizer,
                                      chunk_t=hop, quant="int4")
    tpacks = ttok.pack_encoder_stages(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                                      chunk_t=hop, quant="int4")
    assert set(tpacks) == set(jpacks) == {1, 2, 3}
    _assert_trees_equal(tpacks, jpacks)
    audio = np.random.default_rng(15).normal(size=(2, 3 * hop, 1)).astype(np.float32) * 0.3
    jst = jtok.encoder_state_init(cfg.semantic_tokenizer, 2)
    tst = ttok.encoder_state_init(tcfg.semantic_tokenizer, 2)
    for f in range(3):
        chunk = audio[:, f * hop:(f + 1) * hop]
        jy, jst = jtok.encoder_apply_streaming_fused(
            jp["semantic_encoder"], cfg.semantic_tokenizer, jnp.asarray(chunk), jst,
            fused_packs=jpacks)
        ty, tst = ttok.encoder_apply_streaming_fused(
            tp["semantic_encoder"], tcfg.semantic_tokenizer, torch.tensor(chunk), tst,
            fused_packs=tpacks)
        scale = np.abs(np.asarray(jy)).max()
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4 * scale, rtol=0)


def _jnp_blocks(blocks):
    return [{k: (jnp.asarray(v) if not isinstance(v, dict) else
                 {kk: jnp.asarray(vv) for kk, vv in v.items()}) for k, v in bp.items()}
            for bp in blocks]


def _bits(x):
    """bf16 leaves by their bit patterns, so that packs compare bit for bit."""
    a = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_plain_chain_matches_jax(dtype, t):
    """Two rows through the plain-pack chain for two chunks, each side carrying
    its own context: the JAX single-row kernel once per row, the port's
    batched entry once.  fp32 within TOL of the output's scale; bf16 (inputs,
    packs and outputs) within one bf16 step (2^-7) of it, since the sums run
    in another order before the last rounding."""
    d, n, b = 16, 2, 2
    blocks = _blocks(d, n, seed=20 + t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpack = JFB.pack_stage(_jnp_blocks(blocks), dtype=jdt)
    tpack = TFB.pack_stage(from_jax(blocks), dtype=tdt)
    assert sorted(tpack) == sorted(jpack)
    for k in jpack:
        assert tpack[k].dtype == tdt
        np.testing.assert_array_equal(
            _bits(tpack[k]), np.asarray(jpack[k]).view(np.int16 if dtype == "bfloat16"
                                                       else np.float32))
    rng = np.random.default_rng(t)
    xs = (0.5 * rng.normal(size=(2, b, t, d))).astype(np.float32)
    ctx = (0.5 * rng.normal(size=(b, n, 6, d))).astype(np.float32)
    jctx = [jnp.asarray(ctx[r], jdt) for r in range(b)]
    tctx = torch.tensor(ctx).to(tdt)
    tol = TOL if dtype == "float32" else 2 ** -7
    for x in xs:
        jy = []
        for r in range(b):
            y_r, jctx[r] = JFB.fused_block_chain(jpack, jnp.asarray(x[r], jdt), jctx[r])
            jy.append(np.asarray(y_r, np.float32))
        ty, tctx = TFB.fused_block_chain_plain(tpack, torch.tensor(x).to(tdt), tctx)
        assert ty.dtype == tctx.dtype == tdt and ty.shape == (b, t, d)
        jy = np.stack(jy)
        scale = np.abs(jy).max()
        np.testing.assert_allclose(ty.float().numpy(), jy, atol=tol * scale, rtol=0)
        np.testing.assert_allclose(tctx.float().numpy(),
                                   np.stack([np.asarray(c, np.float32) for c in jctx]),
                                   atol=tol * scale, rtol=0)
        # the single-row entry point gives the batched entry's rows
        y1, _ = TFB.fused_block_chain(tpack, torch.tensor(x[1]).to(tdt), tctx[1])
        assert y1.shape == (t, d) and torch.isfinite(y1.float()).all()


def test_decoder_streaming_with_plain_packs_matches_jax(models):
    """Four frames through the acoustic decoder with its T <= 8 stages on the
    plain chain (fp32 packs), against the JAX package's vmapped kernel."""
    cfg, jp, tp, tcfg = models
    jpacks = jtok.pack_decoder_stages(jp["acoustic_decoder"], cfg.acoustic_tokenizer)
    tpacks = ttok.pack_decoder_stages(tp["acoustic_decoder"], tcfg.acoustic_tokenizer)
    assert set(tpacks) == set(jpacks) == {0, 1, 2}
    _assert_trees_equal(tpacks, jpacks)
    z = np.random.default_rng(16).normal(size=(2, 4, cfg.acoustic_vae_dim)).astype(np.float32)
    jst = jtok.decoder_state_init(cfg.acoustic_tokenizer, 2)
    tst = ttok.decoder_state_init(tcfg.acoustic_tokenizer, 2)
    for f in range(4):
        jy, jst = jtok.decoder_apply_streaming_fused(
            jp["acoustic_decoder"], cfg.acoustic_tokenizer, jnp.asarray(z[:, f:f + 1]), jst,
            fused_packs=jpacks)
        ty, tst = ttok.decoder_apply_streaming_fused(
            tp["acoustic_decoder"], tcfg.acoustic_tokenizer, torch.tensor(z[:, f:f + 1]), tst,
            fused_packs=tpacks)
        scale = np.abs(np.asarray(jy)).max()
        assert scale > 1e-2
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4 * scale, rtol=0)
    for js, ts in zip(jst, tst):
        np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), atol=1e-4, rtol=1e-4)


def test_encoder_streaming_with_plain_packs_matches_jax(models):
    """Three frames through the semantic encoder with its T <= 8 stages on the
    plain chain (fp32 packs)."""
    cfg, jp, tp, tcfg = models
    hop = cfg.speech_compress_ratio
    jpacks = jtok.pack_encoder_stages(jp["semantic_encoder"], cfg.semantic_tokenizer,
                                      chunk_t=hop)
    tpacks = ttok.pack_encoder_stages(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                                      chunk_t=hop)
    assert set(tpacks) == set(jpacks) == {1, 2, 3}
    _assert_trees_equal(tpacks, jpacks)
    audio = np.random.default_rng(17).normal(size=(2, 3 * hop, 1)).astype(np.float32) * 0.3
    jst = jtok.encoder_state_init(cfg.semantic_tokenizer, 2)
    tst = ttok.encoder_state_init(tcfg.semantic_tokenizer, 2)
    for f in range(3):
        chunk = audio[:, f * hop:(f + 1) * hop]
        jy, jst = jtok.encoder_apply_streaming_fused(
            jp["semantic_encoder"], cfg.semantic_tokenizer, jnp.asarray(chunk), jst,
            fused_packs=jpacks)
        ty, tst = ttok.encoder_apply_streaming_fused(
            tp["semantic_encoder"], tcfg.semantic_tokenizer, torch.tensor(chunk), tst,
            fused_packs=tpacks)
        scale = np.abs(np.asarray(jy)).max()
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4 * scale, rtol=0)


def test_paths_outside_the_slice_raise(models):
    """The plain pack runs on the T <= 8 chain now (TPU kernel #6): through
    the single-row entry point and the tokenizer's fused streaming, on the CPU
    without a launch.  Packs of quantized weights still raise."""
    cfg, _, tp, tcfg = models
    blocks = tp["acoustic_decoder"]["stages"][0]
    plain = TFB.pack_stage(blocks)
    assert plain["w1"].shape == (len(blocks), blocks[0]["norm_w"].shape[0] + 8,
                                 blocks[0]["ffn1"]["w"].shape[1])
    gen = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(1, 32, generator=gen), torch.randn(len(blocks), 6, 32, generator=gen)
    before = TFB.fused_block_chain_plain.launches
    y, new_ctx = TFB.fused_block_chain(plain, x, ctx)
    y_ref, ctx_ref = TFB.fused_block_chain_plain_ref(plain, x[None], ctx[None])
    assert torch.equal(y, y_ref[0]) and torch.equal(new_ctx, ctx_ref[0])
    packs = ttok.pack_decoder_stages(tp["acoustic_decoder"], tcfg.acoustic_tokenizer)
    st = ttok.decoder_state_init(tcfg.acoustic_tokenizer, 1)
    out, _ = ttok.decoder_apply_streaming_fused(tp["acoustic_decoder"], tcfg.acoustic_tokenizer,
                                                torch.zeros(1, 1, 8), st, fused_packs=packs)
    assert out.shape == (1, cfg.speech_compress_ratio, 1) and torch.isfinite(out).all()
    assert TFB.fused_block_chain_plain.launches == before  # CPU tensors: the plain version
    quantized = [dict(bp, ffn1={"w": {"qint8": torch.zeros(32, 128, dtype=torch.int8)},
                                "b": None}) for bp in blocks]
    with pytest.raises(ValueError, match="unquantized"):
        TFB.pack_stage_q(quantized)
    with pytest.raises(ValueError, match="plain weights"):
        TFB.pack_stage(quantized)


# (B, T, D, F): the 1.5B stages, B=4, and ragged shapes that leave ranks of a
# cluster without FFN columns or D columns
_PLAN_SHAPES = [(1, 1, 2048, 8192), (1, 8, 1024, 4096), (4, 8, 1024, 4096), (3, 5, 24, 96),
                (2, 3, 352, 1408), (5, 8, 1024, 4096), (1, 1, 4, 16)]


@pytest.mark.parametrize("clusters", [15, 16, 30])
@pytest.mark.parametrize("b,t,d,f", _PLAN_SHAPES)
def test_chain_plan_invariants(b, t, d, f, clusters):
    """The int4 chain kernel's launch plan: FFN columns in whole packed words
    covering F once, no more clusters than the card holds nor than get
    columns, row groups of at most 16 rows that fit shared memory."""
    p = TFB.chain_plan(b, t, d, f, clusters)
    assert p.tf % (16 if d % 16 == 0 and f % 16 == 0 else 4) == 0 and p.tf >= 4
    assert (p.tiles - 1) * p.tf < f <= p.tiles * p.tf
    assert p.clusters == -(-p.tiles // TFB.CLUSTER) <= clusters
    assert 1 <= p.bg <= b and p.bg * t <= 16
    assert p.smem == TFB.chain_smem(d, p.tf, p.bg, t) <= 227 * 1024
    groups = -(-b // p.bg)
    assert -(-b // groups) == p.bg  # balanced: no group is more than one item short


def test_chain_plan_at_the_h100_shapes():
    """On an H100 (15 clusters of 8 CTAs hold at once at 1 CTA per SM): the
    D=2048 stage on 103 CTAs of 80 columns (whole 16-byte columns of W1, the
    tensor map's unit), the D=1024 stages on 86 of 48, B=4 T=8 in two row
    groups of 16 rows; a width whose columns are not whole 16-byte vectors in
    4-column words; a width whose slices do not fit shared memory is
    refused."""
    assert TFB.chain_plan(1, 1, 2048, 8192, 15) == (80, 103, 13, 1, 219728)
    assert TFB.chain_plan(1, 8, 1024, 4096, 15)[:4] == (48, 86, 11, 1)
    assert TFB.chain_plan(4, 8, 1024, 4096, 15)[:4] == (48, 86, 11, 2)
    assert TFB.chain_plan(3, 5, 24, 96, 15)[:4] == (4, 24, 3, 3)
    with pytest.raises(ValueError, match="shared memory"):
        TFB.chain_plan(1, 1, 8192, 32768, 15)


# (B, T, D, F): the 1.5B plain stages at B=1, 2 and 4, a row group count that
# does not divide B, and ragged shapes: ranks of a cluster without D columns
# (D=24), widths that are not whole 16-byte vectors in bf16 (D=36, cp.async),
# clusters part idle (D=352), the smallest width, and D or F not multiples of
# 4 (`tiny_config(n_filters=3)`'s D=6 and D=3, D=30, an odd F)
_PLAIN_SHAPES = [(1, 1, 2048, 8192), (2, 1, 2048, 8192), (4, 1, 2048, 8192),
                 (1, 8, 1024, 4096), (2, 8, 1024, 4096), (4, 8, 1024, 4096), (5, 8, 1024, 4096),
                 (3, 5, 24, 96), (3, 5, 36, 144), (2, 3, 352, 1408), (1, 1, 4, 16),
                 (1, 8, 6, 24), (2, 3, 3, 12), (1, 1, 30, 120), (2, 3, 5, 7)]


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("clusters", [15, 16, 30])
@pytest.mark.parametrize("b,t,d,f", _PLAIN_SHAPES)
def test_plain_plan_invariants(b, t, d, f, clusters, es):
    """The plain chain kernel's launch plan (bf16 and fp32 packs): FFN
    columns in whole 16-byte units of W1 where every row of w1 and w2 is
    whole 16-byte vectors (else in 4-column units), covering F once and
    spread over all the card's CTAs; no more clusters than the card holds
    nor than get columns; row groups of at most 16 rows, balanced; W1 boxes
    and W2 runs whole rows of 4 that divide the block's D rows (D rounded up
    to 4: the kernel pads a ragged D with zeros) and the CTA's columns, boxes
    within the tensor map's limits; two ring stages or more each, all inside
    shared memory."""
    p = TFB.plain_plan(b, t, d, f, es, clusters)
    maps = (d * es) % 16 == 0 and (f * es) % 16 == 0
    unit = 16 // es if maps else 4
    assert p.tf % unit == 0 and (p.tiles - 1) * p.tf < f <= p.tiles * p.tf
    assert p.tf - unit < f / (clusters * TFB.CLUSTER) <= p.tf  # spread over every CTA
    assert p.clusters == -(-p.tiles // TFB.CLUSTER) <= clusters
    assert 1 <= p.bg <= b and p.bg * t <= 16
    assert -(-b // -(-b // p.bg)) == p.bg  # balanced: no group is more than one item short
    assert -(-d // 4) * 4 % p.kb == 0 and p.kb % 4 == 0 and p.kb <= 256
    assert p.tf % p.r2 == 0 and p.r2 % 4 == 0
    if maps:
        assert p.tf <= 256 and (p.tf * es) % 16 == 0
    assert p.ring >= 2 and p.ring2 >= 2
    assert p.smem == TFB.plain_smem(d, p.tf, p.bg, t, es, p.kb, p.ring, p.r2, p.ring2)
    assert p.smem <= 227 * 1024


def test_plain_plan_at_the_h100_shapes():
    """On an H100 (15 clusters of 8 CTAs): the D=2048 stage in bf16 on 114
    CTAs of 72 columns (9 16-byte units), W1 in boxes of 256 rows (36 KB)
    through 2 stages and W2 in runs of 12 rows (48 KB) through 2; the D=1024
    stages on 103 CTAs of 40 with a W1 ring of 3 boxes of 256 rows and a W2
    ring of 2 runs of 20 rows, B=4 T=8 in two row groups of 16 rows; fp32
    packs in 4-column units; a width that is not whole 16-byte vectors in
    4-column units; D or F not multiples of 4 (D=6, F=24 of
    `tiny_config(n_filters=3)`; D=30) plan on D rounded up to 4; widths
    whose rows do not fit shared memory are refused."""
    assert TFB.plain_plan(1, 1, 2048, 8192, 2, 15) == (72, 114, 15, 1, 256, 2, 12, 2, 212768)
    assert TFB.plain_plan(1, 8, 1024, 4096, 2, 15) == (40, 103, 13, 1, 256, 3, 20, 2, 227864)
    assert TFB.plain_plan(4, 8, 1024, 4096, 2, 15)[:4] == (40, 103, 13, 2)
    assert TFB.plain_plan(1, 1, 2048, 8192, 4, 15)[:7] == (72, 114, 15, 1, 128, 2, 4)
    assert TFB.plain_plan(3, 5, 36, 144, 2, 15)[:4] == (4, 36, 5, 3)
    assert TFB.plain_plan(1, 8, 6, 24, 2, 15)[:7] == (4, 6, 1, 1, 8, 2, 4)
    assert TFB.plain_plan(1, 1, 30, 120, 2, 15)[:7] == (4, 30, 4, 1, 32, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        TFB.plain_plan(16, 8, 4096, 16384, 4, 15)
