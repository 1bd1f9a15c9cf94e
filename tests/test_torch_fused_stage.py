"""The port's large-T stage path (`use_fused_stages`: `ops/fused_stage.py`)
against the JAX package's, as tests/test_fused_stage.py checks the JAX kernel:
the packs bit for bit, the plain versions against the JAX Pallas kernels (in
interpret mode on the CPU) for the plain stage over several tiles, every fold
over two chunks of carried state, and the row-lane layout; then the
tokenizer, engine and pipeline with the large-T stages on."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.models import tokenizer as jtok
from vibevoice_tpu.ops import fused_stage as JFS
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.models import tokenizer as ttok
from vibevoice_tpu_torch.ops import fused_blocks as TFB
from vibevoice_tpu_torch.ops import fused_stage as TFS
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests.test_torch_engine import GEN, _inputs, _params, _run
from tests.test_torch_fused_blocks import _blocks
from tests.test_torch_pipeline import _serve

# The TPU kernel's rational erf (|err| < 1.5e-7) against the exact erf, and
# sums in another order: fp32 agreement to a few 1e-6 of the output's scale.
TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(JFS.pl, "pallas_call", lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _bits(x):
    """A pack leaf as comparable numpy (bf16 by its bit pattern)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(t, j, what):
    a, w = _bits(t), _bits(j)
    assert a.dtype == w.dtype and a.shape == w.shape, what
    np.testing.assert_array_equal(a, w, err_msg=what)


def _same_pack(tp, jp, what="pack"):
    assert sorted(tp) == sorted(jp), what
    for k in jp:
        if k in ("conv", "head"):
            tc, jc = tp[k], jp[k]
            attrs = ("kind", "s", "k", "cin") if k == "conv" else ("k", "has_norm")
            assert all(getattr(tc, a) == getattr(jc, a) for a in attrs), (what, k)
            _same(tc.w, jc.w, f"{what}/{k}/w")
            if jc.b is None:
                assert tc.b is None
            else:
                _same(tc.b, jc.b, f"{what}/{k}/b")
        elif k == "rowlane":
            _same_pack(tp[k], jp[k], f"{what}/rowlane")
        else:
            _same(tp[k], jp[k], f"{what}/{k}")


def _close(got, want, scale=None, tol=TOL):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got.numpy(), want, atol=tol * scale, rtol=0)


def _rnd(rng, *shape, s=0.5):
    return (s * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packs_equal_jax(dtype):
    d, n, s = 16, 2, 4
    blocks = _blocks(d, n, seed=1)
    rng = np.random.default_rng(2)
    up = {"w": _rnd(rng, 8, 2 * s, d), "b": _rnd(rng, d)}
    down = {"w": _rnd(rng, 2 * s, 8, d), "b": None}
    stem = {"w": _rnd(rng, 7, 1, d), "b": _rnd(rng, d)}
    head = {"w": _rnd(rng, 7, d, 1), "b": _rnd(rng, 1)}
    norm = _rnd(rng, d) + 1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _same_pack(TFS.pack_stage(from_jax(blocks), dtype=td), JFS.pack_stage(_j(blocks), dtype=jd))
    for r in (2, 4):
        _same_pack(TFS.pack_stage_rowlane(from_jax(blocks), r, dtype=td),
                   JFS.pack_stage_rowlane(_j(blocks), r, dtype=jd))
    _same_pack({"conv": TFS.pack_up_conv(from_jax(up), s, dtype=td)},
               {"conv": JFS.pack_up_conv(_j(up), s, dtype=jd)})
    _same_pack({"conv": TFS.pack_down_conv(from_jax(down), s, dtype=td)},
               {"conv": JFS.pack_down_conv(_j(down), s, dtype=jd)})
    _same_pack({"conv": TFS.pack_down_conv(from_jax(stem), 1, dtype=td)},
               {"conv": JFS.pack_down_conv(_j(stem), 1, dtype=jd)})
    for nw in (norm, None):
        _same_pack({"head": TFS.pack_head(from_jax(head), from_jax(nw), dtype=td)},
                   {"head": JFS.pack_head(_j(head), None if nw is None else jnp.asarray(nw),
                                          dtype=jd)})


@pytest.mark.parametrize("kw", [dict(), dict(t_min=16), dict(fold_conv=False),
                                dict(fold_head=False), dict(fold_conv=False, rowlane_batch=2),
                                dict(fold_conv=False, rowlane_batch=4)])
def test_stages_large_equal_jax(kw):
    cfg, jp = tiny_params()
    tp, tcfg = from_jax(to_np(jp)), TC.tiny_config(vocab_size=320)
    kw = dict({"t_min": 7}, **kw)
    jdec = jtok.pack_decoder_stages_large(jp["acoustic_decoder"], cfg.acoustic_tokenizer, **kw)
    tdec = ttok.pack_decoder_stages_large(tp["acoustic_decoder"], tcfg.acoustic_tokenizer, **kw)
    kw.pop("fold_head", None)
    hop = cfg.speech_compress_ratio
    jenc = jtok.pack_encoder_stages_large(jp["semantic_encoder"], cfg.semantic_tokenizer,
                                          chunk_t=hop, **kw)
    tenc = ttok.pack_encoder_stages_large(tp["semantic_encoder"], tcfg.semantic_tokenizer,
                                          chunk_t=hop, **kw)
    assert set(tdec) == set(jdec) and set(tenc) == set(jenc) and tdec and tenc
    for i in jdec:
        _same_pack(tdec[i], jdec[i], f"decoder {i}")
    for i in jenc:
        _same_pack(tenc[i], jenc[i], f"encoder {i}")


@pytest.mark.parametrize("b,t,d,n,tile", [(1, 48, 16, 3, 16), (2, 48, 8, 2, 400),
                                          (3, 200, 8, 1, 40), (2, 24, 32, 2, 8)])
def test_plain_stage_matches_jax(b, t, d, n, tile):
    """Several T-tiles in the JAX kernel (the conv context crosses tiles in
    its scratch); the port's result does not depend on `tile_want`."""
    blocks = _blocks(d, n, seed=t + d)
    rng = np.random.default_rng(b * t)
    x, ctx = _rnd(rng, b, t, d), _rnd(rng, b, n, 6, d)
    jpk, tpk = JFS.pack_stage(_j(blocks)), TFS.pack_stage(from_jax(blocks))
    jy, jc = JFS.fused_stage_chain(jpk, jnp.asarray(x), jnp.asarray(ctx), tile_want=tile)
    ty, tc = TFS.fused_stage_chain(tpk, torch.tensor(x), torch.tensor(ctx), tile_want=tile)
    scale = np.abs(np.asarray(jy)).max()
    _close(ty, jy, scale)
    _close(tc, jc, scale)
    ty2, tc2 = TFS.fused_stage_chain(tpk, torch.tensor(x), torch.tensor(ctx), tile_want=t)
    assert torch.equal(ty, ty2) and torch.equal(tc, tc2)


def _two_chunks(tpk, jpk, xs, ctx, state_shape, state_kw, rng):
    """Two chunks through both packages with every returned state carried."""
    c_t, c_j = torch.tensor(ctx), jnp.asarray(ctx)
    s0 = _rnd(rng, *state_shape)
    s_t, s_j = torch.tensor(s0), jnp.asarray(s0)
    for x in xs:
        jo = JFS.fused_stage_chain(jpk, jnp.asarray(x), c_j, **{state_kw: s_j})
        to = TFS.fused_stage_chain(tpk, torch.tensor(x), c_t, **{state_kw: s_t})
        assert len(to) == len(jo) == 3
        scale = np.abs(np.asarray(jo[0])).max()
        for got, want in zip(to, jo):
            assert tuple(got.shape) == want.shape
            _close(got, want, scale)
        c_t, s_t, c_j, s_j = to[1], to[2], jo[1], jo[2]


@pytest.mark.parametrize("s,din,d,t", [(5, 16, 8, 40), (2, 8, 16, 64)])
def test_folded_up_conv_matches_jax(s, din, d, t):
    n, b = 2, 2
    rng = np.random.default_rng(s)
    blocks = _blocks(d, n, seed=3)
    up = {"w": _rnd(rng, din, 2 * s, d, s=0.2), "b": _rnd(rng, d, s=0.1)}
    jpk = dict(JFS.pack_stage(_j(blocks)), conv=JFS.pack_up_conv(_j(up), s))
    tpk = dict(TFS.pack_stage(from_jax(blocks)), conv=TFS.pack_up_conv(from_jax(up), s))
    xs = [_rnd(rng, b, t // s, din) for _ in range(2)]
    _two_chunks(tpk, jpk, xs, _rnd(rng, b, n, 6, d), (b, s, d), "conv_state", rng)


@pytest.mark.parametrize("s,k,cin,d,t", [(1, 7, 1, 8, 40), (2, 4, 4, 8, 64), (4, 8, 8, 16, 48)])
def test_folded_down_conv_matches_jax(s, k, cin, d, t):
    n, b = 2, 2
    rng = np.random.default_rng(k)
    blocks = _blocks(d, n, seed=4)
    dp = {"w": _rnd(rng, k, cin, d, s=0.2), "b": _rnd(rng, d, s=0.1)}
    jpk = dict(JFS.pack_stage(_j(blocks)), conv=JFS.pack_down_conv(_j(dp), s))
    tpk = dict(TFS.pack_stage(from_jax(blocks)), conv=TFS.pack_down_conv(from_jax(dp), s))
    xs = [_rnd(rng, b, t * s, cin) for _ in range(2)]
    _two_chunks(tpk, jpk, xs, _rnd(rng, b, n, 6, d), (b, k - s, cin), "conv_state", rng)


@pytest.mark.parametrize("has_norm", [True, False])
def test_head_fold_matches_jax(has_norm):
    d, n, b, t = 8, 2, 2, 32
    rng = np.random.default_rng(5)
    blocks = _blocks(d, n, seed=5)
    head = {"w": _rnd(rng, 7, d, 1), "b": _rnd(rng, 1)}
    norm = _rnd(rng, d, s=0.1) + 1 if has_norm else None
    jpk = dict(JFS.pack_stage(_j(blocks)),
               head=JFS.pack_head(_j(head), None if norm is None else jnp.asarray(norm)))
    tpk = dict(TFS.pack_stage(from_jax(blocks)),
               head=TFS.pack_head(from_jax(head), from_jax(norm)))
    xs = [_rnd(rng, b, t, d) for _ in range(2)]
    _two_chunks(tpk, jpk, xs, _rnd(rng, b, n, 6, d), (b, 6, d), "head_state", rng)


@pytest.mark.parametrize("b,t,d,n,r", [(4, 40, 8, 2, 4), (4, 64, 16, 3, 2), (2, 24, 32, 1, 2)])
def test_rowlane_matches_jax_and_plain_stage(b, t, d, n, r):
    """The row-lane path against the JAX row-lane kernel and against the
    port's plain stage on the same rows, over two chunks."""
    rng = np.random.default_rng(r * d)
    blocks = _blocks(d, n, seed=6)
    plain_t = TFS.pack_stage(from_jax(blocks))
    jpk = dict(JFS.pack_stage(_j(blocks)), rowlane=JFS.pack_stage_rowlane(_j(blocks), r))
    tpk = dict(plain_t, rowlane=TFS.pack_stage_rowlane(from_jax(blocks), r))
    ctx = _rnd(rng, b, n, 6, d)
    c_j, c_t, c_p = jnp.asarray(ctx), torch.tensor(ctx), torch.tensor(ctx)
    for _ in range(2):
        x = _rnd(rng, b, t, d)
        jy, c_j = JFS.fused_stage_chain(jpk, jnp.asarray(x), c_j)
        ty, c_t = TFS.fused_stage_chain(tpk, torch.tensor(x), c_t)
        py, c_p = TFS.fused_stage_chain(plain_t, torch.tensor(x), c_p)
        scale = np.abs(np.asarray(jy)).max()
        for got, want in ((ty, jy), (c_t, c_j), (ty, py.numpy()), (c_t, c_p.numpy())):
            _close(got, want, scale)
    # a batch the row group does not divide takes the plain stage
    x = torch.tensor(_rnd(rng, b + 1, t, d))
    c = torch.tensor(_rnd(rng, b + 1, n, 6, d))
    for got, want in zip(TFS.fused_stage_chain(tpk, x, c), TFS.fused_stage_chain_ref(plain_t, x, c)):
        assert torch.equal(got, want)


def test_rowlane_rows_policy():
    assert TFS.rowlane_rows(32, 8) == 4
    assert TFS.rowlane_rows(64, 8) == 2
    assert TFS.rowlane_rows(32, 2) == 2
    assert TFS.rowlane_rows(128, 8) == 1
    assert TFS.rowlane_rows(32, 1) == 1
    assert TFS.rowlane_rows(32, 6) == 3
    for d, bsz in ((32, 8), (64, 8), (32, 6), (16, 12), (128, 4)):
        assert TFS.rowlane_rows(d, bsz) == JFS.rowlane_rows(d, bsz)


def test_engine_auto_policies():
    """Folds iff B == 1 and the tail never unless asked, and the row-lane
    layout at 2 <= B <= 4 and B >= 32 unless asked otherwise: the JAX
    engine's rules, on both engines."""
    cfg, jp, tp = _params()
    tcfg = TC.tiny_config(vocab_size=320)
    gen = TG.GenerationConfig(**GEN)

    def build(b, **kw):
        return TG.Engine(tp, tcfg, gen, max_steps=2, batch=b, prompt_len=16, device="cpu",
                         use_fused_stages=True, fused_stage_t_min=7, **kw)

    def build_jax(b):
        return JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), max_steps=2, batch=b,
                         prompt_len=16, use_fused_stages=True, fused_stage_t_min=7)

    has = lambda eng, key, what: any(what in p for p in eng.params[key].values())
    e1, e8 = build(1), build(8)
    for key in ("_vocoder_packs_large", "_semantic_packs_large"):
        assert has(e1, key, "conv") and not has(e8, key, "conv")
        for b in (1, 2, 4, 8, 32):
            eng = e1 if b == 1 else e8 if b == 8 else build(b)
            assert has(eng, key, "rowlane") == (2 <= b <= 4 or b >= 32)
            assert has(eng, key, "rowlane") == has(build_jax(b), key, "rowlane")
        for b in (2, 4, 8, 32):
            assert has(build(b, fused_stage_rowlane=True), key, "rowlane")
            assert not has(build(b, fused_stage_rowlane=False), key, "rowlane")
        assert not has(build(1, fused_stage_rowlane=True), key, "rowlane")
    assert not any("head" in p for p in e1.params["_vocoder_packs_large"].values())
    e1h = build(1, fused_stage_fold_head=True)
    assert any("head" in p for p in e1h.params["_vocoder_packs_large"].values())
    e8f = build(8, fused_stage_fold_conv=True)
    assert any("conv" in p for p in e8f.params["_vocoder_packs_large"].values())


def _engine_pair(b, cfg, jp, tp, **extra):
    kw = dict(max_steps=16, batch=b, prompt_len=24, inject_latent_noise=True,
              use_fused_stages=True, fused_stage_t_min=7, **extra)
    je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), **kw)
    te = TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                   device="cpu", **kw)
    return je, te


def _assert_runs_match(je, te, b):
    ins = _inputs()
    args = [a[:b] for a in ins[:5]] + [ins[5][:, :b]]
    jr, (jtok_, jchunk, jemit, _) = _run(JG, je, *args)
    tr, (ttok_, tchunk, temit, _) = _run(TG, te, *args)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(ttok_, jtok_)
    np.testing.assert_array_equal(temit, jemit)
    assert temit.any()
    scale = max(np.abs(a).max() for a in jr.audio if a is not None)
    assert scale > 1e-2
    np.testing.assert_allclose(tchunk, jchunk, atol=1e-4 * scale, rtol=0)
    for a, want in zip(tr.audio, jr.audio):
        np.testing.assert_allclose(a, want, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("b,fold_head", [(1, False), (1, True), (2, False)])
def test_engine_fused_stages_matches_jax(b, fold_head):
    """B=1 (folded convs, and with the folded tail) and B=2 (row-lane, asked
    for on both sides), dpmsolver++ with injected noise: equal tokens and
    `emitted`, audio within 1e-4 of its scale."""
    je, te = _engine_pair(b, *_params(), fused_stage_fold_head=fold_head,
                          fused_stage_rowlane=b == 2)
    kinds = {k for p in te.params["_vocoder_packs_large"].values() for k in p}
    assert ("conv" in kinds) == (b == 1) and ("rowlane" in kinds) == (b == 2)
    assert ("head" in kinds) == fold_head
    _assert_runs_match(je, te, b)


def test_engine_b2_default_policy_matches_jax():
    """At B=2 with the default policies both engines take the row-lane
    layout: the same tokens and audio."""
    je, te = _engine_pair(2, *_params())
    for key in ("_vocoder_packs_large", "_semantic_packs_large"):
        assert any("rowlane" in p for p in je.params[key].values())
        assert any("rowlane" in p for p in te.params[key].values())
    _assert_runs_match(je, te, 2)


def test_from_jax_carries_large_packs():
    """A JAX engine's params, large packs included (folds at B=1, row-lane at
    B=2), carry over through `weights.from_jax`, equal the port's own packs
    and drive the port's engine to the JAX engine's audio."""
    cfg, jp, _ = _params()
    for b in (1, 2):
        je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), max_steps=16, batch=b,
                       prompt_len=24, inject_latent_noise=True, use_fused_stages=True,
                       fused_stage_t_min=7)
        carried = from_jax(to_np(je.params))
        own = TG.Engine(from_jax(to_np(jp)), TC.tiny_config(vocab_size=320),
                        TG.GenerationConfig(**GEN), max_steps=16, batch=b, prompt_len=24,
                        device="cpu", use_fused_stages=True, fused_stage_t_min=7,
                        fused_stage_rowlane=True)
        for key in ("_vocoder_packs_large", "_semantic_packs_large"):
            assert set(carried[key]) == set(own.params[key]) and carried[key]
            for i in carried[key]:
                _same_pack(carried[key][i], own.params[key][i], f"{key}/{i}")
        te = TG.Engine(carried, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                       max_steps=16, batch=b, prompt_len=24, inject_latent_noise=True,
                       device="cpu", use_fused_stages=True, fused_stage_t_min=7)
        _assert_runs_match(je, te, b)


@pytest.mark.parametrize("modes", [dict(), dict(quantize="int4", quantize_tokenizer="int4k",
                                                quantize_diffusion="int4k")])
def test_pipeline_with_fused_stages_serves(modes):
    """`VibeVoiceTTS(use_fused_stages=True)` serves on the CPU, alone and with
    the int4 modes (its large stages stay plain and take the stage packs)."""
    tts = VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                   ddpm_steps=2, prompt_bucket=64, device="cpu",
                                   algorithm_type="sde-dpmsolver++", use_fused_stages=True,
                                   **modes)
    _serve(tts)
    engines = list(tts._engines.values())
    assert engines and all(e.use_fused_stages and e.params["_vocoder_packs_large"]
                           and e.params["_semantic_packs_large"] for e in engines)


def test_plain_chain_packs_still_refused():
    """Plain packs (the stage kernel's) now run where they meet the T <= 8
    chain (TPU kernel #6): fused streaming with them equals the block-by-block
    path, and `Engine(use_fused_vocoder/semantic)` builds them itself, also
    beside the large-T stage packs."""
    cfg, _, tp = _params()
    tcfg = TC.tiny_config(vocab_size=320)
    packs = ttok.pack_decoder_stages(tp["acoustic_decoder"], tcfg.acoustic_tokenizer)
    assert set(packs) == {0, 1, 2} and all("w1" in p for p in packs.values())
    z = torch.tensor(np.random.default_rng(3).normal(size=(1, 2, cfg.acoustic_vae_dim)),
                     dtype=torch.float32)
    st_f = st_p = ttok.decoder_state_init(tcfg.acoustic_tokenizer, 1)
    for f in range(2):
        got, st_f = ttok.decoder_apply_streaming_fused(
            tp["acoustic_decoder"], tcfg.acoustic_tokenizer, z[:, f:f + 1], st_f,
            fused_packs=packs)
        want, st_p = ttok.decoder_apply_streaming(tp["acoustic_decoder"],
                                                  tcfg.acoustic_tokenizer, z[:, f:f + 1], st_p)
        scale = float(want.abs().max())
        assert scale > 1e-2
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    for kw in (dict(use_fused_vocoder=True), dict(use_fused_semantic=True),
               dict(use_fused_vocoder=True, use_fused_stages=True)):
        eng = TG.Engine(tp, tcfg, TG.GenerationConfig(**GEN), max_steps=4, batch=1,
                        prompt_len=8, device="cpu", fused_stage_t_min=7, **kw)
        for flag, key in (("use_fused_vocoder", "_vocoder_packs"),
                          ("use_fused_semantic", "_semantic_packs")):
            assert (key in eng.params) == bool(kw.get(flag))
            assert all("w1" in p for p in eng.params.get(key, {}).values())


@pytest.mark.parametrize("f,dtype,want", [
    (1024, torch.bfloat16, 8), (512, torch.bfloat16, 8),   # D=256, 128: 128 / 64 columns a CTA
    (256, torch.bfloat16, 4), (128, torch.bfloat16, 2),    # D=64, 32
    (16, torch.float32, 1), (32, torch.float32, 1), (200, torch.bfloat16, 1)])
def test_cluster_size_splits_the_ffn_columns(f, dtype, want):
    """The stage kernel's CTAs per cluster: at most the portable 8, FFN
    column slices of at least 64 columns and of whole 16-byte vectors."""
    c = TFS.cluster_size(f, dtype)
    assert c == want and 1 <= c <= TFS.MAX_CLUSTER and f % c == 0
    es = torch.finfo(dtype).bits // 8
    assert c == 1 or (f // c >= TFS.CLUSTER_COLS and (f // c * es) % 16 == 0)


def test_stage_scratch_is_cached_per_stream_and_size():
    """One scratch per device, stream and size, for the stage kernel and its
    row-lane form alike (the row-lane form keeps no scratch of its own)."""
    dev = torch.device("cpu")
    buf = TFS.scratch(dev, 3, 800 * 128, 2 * 800 * 128)
    assert set(buf) == {"xg", "xb", "yg", "bar"}
    assert buf["xg"].numel() == 2 * 800 * 128 and buf["xb"].numel() == 800 * 128
    assert buf["bar"].dtype == torch.int32 and not buf["bar"].any()
    assert TFS.scratch(dev, 3, 800 * 128, 2 * 800 * 128) is buf
    assert TFS.scratch(dev, 4, 800 * 128, 2 * 800 * 128) is not buf
    rl = TFS.scratch(dev, 3, 100, 0)
    assert set(rl) == {"xg", "xb", "yg", "bar"} and rl["yg"].numel() == 100


def _flat_view(t, shape, ld, offset):
    """What the kernel reads of a pack tensor: `shape` elements from its
    flat storage at `offset`, rows `ld` apart."""
    strides = (ld, 1) if len(shape) == 2 else (1,)
    return t.reshape(-1).as_strided(shape, strides, offset)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_stage_layout_reads_each_lane_groups_blocks(r):
    """`stage_layout`'s strides and lane offsets, applied to the flat pack
    as the kernel applies them for batch item bb (lane group bb % r), give
    that lane group's slices of the pack (its vectors and the diagonal
    blocks of w1, b1 and w2), which equal the plain pack's vectors, w1 rows,
    bias row and w2."""
    d, n = 8, 3
    blocks = from_jax(_blocks(d, n, seed=6))
    base = TFS.pack_stage(blocks)
    f = base["w2"].shape[1]
    pack = base if r == 1 else TFS.pack_stage_rowlane(blocks, r)
    lay = TFS.stage_layout(d, f, r)
    assert lay["lanes"] == r
    # a plain pack's b1 is row D of w1, which the wrapper passes as b1's base
    b1, b1_at = (base["w1"], d * f) if r == 1 else (pack["b1"], 0)
    for nb in range(n):
        for bb in range(2 * r):
            g = bb % lay["lanes"]
            cols, fcols = slice(g * d, (g + 1) * d), slice(g * f, (g + 1) * f)
            at = lambda k: nb * lay[f"{k}_stride"] + g * lay[f"{k}_lane"]
            vec_at = nb * 8 * lay["vec_ld"] + g * lay["vec_lane"]
            views = {
                "vecs": (_flat_view(pack["vecs"], (8, d), lay["vec_ld"], vec_at),
                         pack["vecs"][nb, :, cols], base["vecs"][nb]),
                "mixw": (_flat_view(pack["mixw"], (8, d), lay["vec_ld"], vec_at),
                         pack["mixw"][nb, :, cols], base["mixw"][nb]),
                "w1": (_flat_view(pack["w1"], (d, f), lay["w1_ld"], at("w1")),
                       pack["w1"][nb, cols, fcols] if r > 1 else pack["w1"][nb, :d],
                       base["w1"][nb, :d]),
                "b1": (_flat_view(b1, (f,), 1, b1_at + at("b1")),
                       pack["b1"][nb, 0, fcols] if r > 1 else pack["w1"][nb, d],
                       base["w1"][nb, d]),
                "w2": (_flat_view(pack["w2"], (f, d), lay["w2_ld"], at("w2")),
                       pack["w2"][nb, fcols, cols] if r > 1 else pack["w2"][nb],
                       base["w2"][nb]),
            }
            for k, (read, sliced, plain) in views.items():
                assert torch.equal(read, sliced) and torch.equal(read, plain), (k, nb, bb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 4])
def test_rowlane_packs_are_block_diagonal(r, dtype):
    """The row-lane packs of the port and of the JAX package (carried by
    `weights.from_jax`): the off-diagonal blocks of w1 and w2 are exact
    zeros, and lane group g's diagonal blocks, bias columns and vectors
    equal the plain pack's w1 rows, bias row, w2 and vectors.  So the row-lane
    kernel, which reads only the diagonal blocks, computes what the whole
    block-diagonal product computes."""
    d, n = 16, 2
    blocks = _blocks(d, n, seed=9)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    base = TFS.pack_stage(from_jax(blocks), dtype=td)
    f = base["w2"].shape[1]
    packs = {"port": TFS.pack_stage_rowlane(from_jax(blocks), r, dtype=td),
             "jax": from_jax(to_np(JFS.pack_stage_rowlane(_j(blocks), r, dtype=jd)))}
    for who, rl in packs.items():
        assert rl["w1"].dtype == td and rl["avg"].dtype == torch.float32, who
        for g in range(r):
            cols, fcols = slice(g * d, (g + 1) * d), slice(g * f, (g + 1) * f)
            assert torch.equal(rl["w1"][:, cols, fcols], base["w1"][:, :d]), (who, g)
            assert torch.equal(rl["b1"][:, 0, fcols], base["w1"][:, d]), (who, g)
            assert torch.equal(rl["w2"][:, fcols, cols], base["w2"]), (who, g)
            assert torch.equal(rl["vecs"][:, :, cols], base["vecs"]), (who, g)
            assert torch.equal(rl["mixw"][:, :, cols], base["mixw"]), (who, g)
        # everything off the diagonal blocks is an exact zero
        diag1 = torch.block_diag(*[torch.ones(d, f)] * r).bool()
        assert (rl["w1"][:, ~diag1] == 0).all() and (rl["w2"][:, ~diag1.T] == 0).all(), who
