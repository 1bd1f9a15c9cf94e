"""The port's weight quantization (`utils/quantize.py`) against the JAX
package's, as tests/test_quantize.py and tests/test_tokenizer_quantize.py
check it: q values and scales bit-equal for every mode, group size and
tokenizer skip set; the int8 conv paths, int8 embedding rows and the
quantized logits-head subsets giving the JAX package's numbers."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vibevoice_tpu.models import qwen2 as jq2, tokenizer as jtok, vibevoice as JV
from vibevoice_tpu.ops import conv as jconv
from vibevoice_tpu.utils import quantize as JQ
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import qwen2 as tq2, tokenizer as ttok, vibevoice as TV
from vibevoice_tpu_torch.ops import conv as tconv
from vibevoice_tpu_torch.utils import quantize as TQ
from vibevoice_tpu_torch.weights import from_jax

from tests._torch_parity import tiny_params, to_np
from tests.test_torch_quant_engine import _flat, _np


def _assert_trees_equal(t_tree, j_tree):
    tf, jf = _flat(t_tree), _flat(j_tree)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        if jf[k] is None:
            assert tf[k] is None, k
            continue
        a, w = _np(tf[k]), _np(jf[k])
        assert a.dtype == w.dtype and a.shape == w.shape, k
        np.testing.assert_array_equal(a, w, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (1536, 640)])
def test_quantize_weight_and_int4_bit_equal(dtype, shape):
    w = np.random.default_rng(0).normal(0, 0.02, shape).astype(np.float32)
    wj = jnp.asarray(w).astype(dtype)
    wt = torch.tensor(np.asarray(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    _assert_trees_equal(TQ.quantize_weight(wt), JQ.quantize_weight(wj))
    _assert_trees_equal(TQ.quantize_weight(wt, axis=1), JQ.quantize_weight(wj, axis=1))
    for gs in (None, 32):
        _assert_trees_equal(TQ.quantize_weight_int4(wt, gs), JQ.quantize_weight_int4(wj, gs))


@pytest.mark.parametrize("mode,gs,tok", [("int8", None, None), ("int4", None, "int8"),
                                         ("int4", 16, "int4"), ("int4f", None, "int4"),
                                         ("int4f", 16, "int8")])
def test_quantize_model_bit_equal(mode, gs, tok):
    """LM (fused qkv/gateup under int4), logits head, diffusion head and the
    tokenizer stacks, with the chain-pack skip sets and the embedding."""
    _, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    kw = dict(mode=mode, group_size=gs, quantize_embed=True, tokenizer_mode=tok,
              tokenizer_min_dim=4,
              tokenizer_skip={"acoustic_decoder": {0, 1}, "semantic_encoder": {3}})
    jout = JQ.quantize_model(jp, True, **kw)
    tout = TQ.quantize_model(tp, True, **kw)
    _assert_trees_equal(tout, jout)
    if mode == "int4":
        assert "qkv" in tout["lm"]["layers"][0] and "q" not in tout["lm"]["layers"][0]
    if tok:
        # skipped stages stay plain, the others are quantized
        assert not isinstance(tout["acoustic_decoder"]["stages"][0][0]["ffn1"]["w"], dict)
        assert isinstance(tout["acoustic_decoder"]["stages"][3][0]["ffn1"]["w"], dict)
    # the diffusion head under int4 itself (the pipeline's default is int8)
    _assert_trees_equal(TQ.quantize_diffusion_head(tp["diffusion_head"], "int4", gs),
                        JQ.quantize_diffusion_head(jp["diffusion_head"], "int4", gs))


def test_int8_conv_paths_match_jax():
    """k == 2*stride downsampling conv (full and streaming) and the
    transposed conv with per-(tap, channel) scales."""
    rng = np.random.default_rng(5)
    stride, cin, cout = 2, 4, 6
    w = rng.normal(size=(2 * stride, cin, cout)).astype(np.float32)
    wt = rng.normal(size=(cin, 2 * stride, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(2, 9, cin)).astype(np.float32)
    jw, tw = JQ.quantize_conv_weight(jnp.asarray(w)), TQ.quantize_conv_weight(torch.tensor(w))
    _assert_trees_equal(tw, jw)
    want = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jw, jnp.asarray(b), stride=stride))
    got = tconv.causal_conv1d(torch.tensor(x), tw, torch.tensor(b), stride=stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jst = jconv.conv_state_init(2, cin, 2 * stride, stride)
    tst = tconv.conv_state_init(2, cin, 2 * stride, stride)
    for i in range(0, 8, 4):
        jy, jst = jconv.causal_conv1d_streaming(jnp.asarray(x[:, i:i + 4]), jst, jw,
                                                jnp.asarray(b), stride=stride)
        ty, tst = tconv.causal_conv1d_streaming(torch.tensor(x[:, i:i + 4]), tst, tw,
                                                torch.tensor(b), stride=stride)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tst.buf.numpy(), np.asarray(jst.buf))
    jwt, twt = JQ.quantize_convt_weight(jnp.asarray(wt)), TQ.quantize_convt_weight(torch.tensor(wt))
    _assert_trees_equal(twt, jwt)
    want = np.asarray(jconv.causal_conv_transpose1d(jnp.asarray(x), jwt, jnp.asarray(b), stride))
    got = tconv.causal_conv_transpose1d(torch.tensor(x), twt, torch.tensor(b), stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jst = jconv.conv_transpose_state_init(2, cout, 2 * stride, stride)
    tst = tconv.conv_transpose_state_init(2, cout, 2 * stride, stride)
    for i in range(0, 9, 3):
        jy, jst = jconv.causal_conv_transpose1d_streaming(jnp.asarray(x[:, i:i + 3]), jst, jwt,
                                                          jnp.asarray(b), stride)
        ty, tst = tconv.causal_conv_transpose1d_streaming(torch.tensor(x[:, i:i + 3]), tst,
                                                          twt, torch.tensor(b), stride)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_tokenizer_stacks_match_jax(mode):
    """Both stacks with every FFN and transition conv quantized
    (min_dim and conv_min_params at 0), full and one streaming frame."""
    cfg, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    tcfg = TC.tiny_config(vocab_size=320)
    kw = dict(mode=mode, min_dim=0, conv_min_params=0)
    jd = JQ.quantize_tokenizer_stack(jp["acoustic_decoder"], **kw)
    td = TQ.quantize_tokenizer_stack(tp["acoustic_decoder"], **kw)
    je = JQ.quantize_tokenizer_stack(jp["semantic_encoder"], **kw)
    te = TQ.quantize_tokenizer_stack(tp["semantic_encoder"], **kw)
    _assert_trees_equal(td, jd)
    _assert_trees_equal(te, je)
    assert isinstance(td["up"][1]["w"], dict) and isinstance(te["down"][1]["w"], dict)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(2, 3, cfg.acoustic_vae_dim)).astype(np.float32)
    want = np.asarray(jtok.decoder_apply(jd, cfg.acoustic_tokenizer, jnp.asarray(z)))
    got = ttok.decoder_apply(td, tcfg.acoustic_tokenizer, torch.tensor(z)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    hop = cfg.speech_compress_ratio
    audio = rng.normal(size=(2, hop, 1)).astype(np.float32) * 0.3
    jst = jtok.encoder_state_init(cfg.semantic_tokenizer, 2)
    tst = ttok.encoder_state_init(tcfg.semantic_tokenizer, 2)
    want, _ = jtok.encoder_apply_streaming(je, cfg.semantic_tokenizer, jnp.asarray(audio), jst)
    got, _ = ttok.encoder_apply_streaming(te, tcfg.semantic_tokenizer, torch.tensor(audio), tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * np.abs(np.asarray(want)).max(), rtol=0)


def test_int8_embedding_rows_and_logits_match_jax():
    _, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    cfg = TC.tiny_config(vocab_size=320).decoder
    jlm = JQ.quantize_lm(jp["lm"], quantize_embed=True)
    tlm = TQ.quantize_lm(tp["lm"], quantize_embed=True)
    ids = np.array([[0, 5, 258, 319], [7, 7, 1, 260]], np.int32)
    # rows come out in the scales' dtype (bf16), in both packages
    want = np.asarray(jq2.embed_rows(jlm, jnp.asarray(ids)).astype(jnp.float32))
    got = tq2.embed_rows(tlm, torch.tensor(ids).long()).float().numpy()
    np.testing.assert_array_equal(got, want)
    h = np.random.default_rng(7).normal(size=(2, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jq2.logits(jlm, None, jnp.asarray(h)))
    got = tq2.logits(tlm, cfg, torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("head", ["int8", "int4", "int4-gs16", "int8-embed"])
def test_lm_head_subset_matches_jax(head):
    """The subset columns of a quantized head: int8 kept as int8 + scales,
    int4 dequantized once to the engine dtype (bf16 by default)."""
    _, jp = tiny_params()
    tp = from_jax(to_np(jp), device="cpu")
    ids = [256, 258, 259, 260]
    if head == "int8-embed":
        jp = dict(jp, lm=JQ.quantize_lm(jp["lm"], quantize_embed=True))
        tp = dict(tp, lm=TQ.quantize_lm(tp["lm"], quantize_embed=True))
    else:
        mode, gs = head.split("-gs")[0], (16 if "gs" in head else None)
        emb_j, emb_t = jp["lm"]["embed"].T, tp["lm"]["embed"].T
        jp = dict(jp, lm_head=JQ._quant(emb_j, mode, gs))
        tp = dict(tp, lm_head=TQ._quant(emb_t, mode, gs))
    jsub = JV.lm_head_subset(jp, ids)
    tsub = TV.lm_head_subset(tp, ids)
    _assert_trees_equal(tsub, jsub)
    h = np.random.default_rng(8).normal(size=(2, 64)).astype(np.float32)
    want = np.asarray(JV.lm_logits_subset(jsub, jnp.asarray(h)))
    got = TV.lm_logits_subset(tsub, torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
