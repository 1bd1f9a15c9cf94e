"""The port's DeepSeek-V2 decoder (`models/deepseek_v2.py`: latent attention,
experts, YaRN RoPE) on the CPU at a tiny size against the plain float32
reference `portbench/reference/deepseek_v2.py`, and the engine running it.

Every comparison is in float32 on the CPU, where the port and the reference
differ only by the order of their sums (the absorbed form regroups the
attention's products, the experts are summed in another order), so each
tolerance is a few float32 roundings of the compared values: 2e-5 relative.
"""
import dataclasses
import math
import types

import pytest
import torch

from portbench.reference import deepseek_v2 as RD
from vibevoice_tpu_torch import configs as C
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import deepseek_v2 as D
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.utils.profiling import Tracer

RTOL = 2e-5  # float32 sums in another order (see the module docstring)


def tiny_decoder(**kw) -> C.DeepseekV2Config:
    """Hidden 64, 4 heads, kv_lora 32, rope 16 / nope 16 / v 16, 8 experts
    top-2 and 1 shared, layer 0 dense, 3 layers, YaRN over 32 positions."""
    base = dict(vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
                num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                max_position_embeddings=1024, rope_factor=4.0,
                original_max_position_embeddings=32)
    return C.DeepseekV2Config(**dict(base, **kw))


def ref_decoder(dec: C.DeepseekV2Config) -> RD.DeepseekV2Config:
    names = {f.name for f in dataclasses.fields(RD.DeepseekV2Config)}
    return RD.DeepseekV2Config(**{k: v for k, v in vars(dec).items() if k in names})


def tiny_vibevoice(**kw) -> C.VibeVoiceConfig:
    return dataclasses.replace(C.tiny_config(hidden_size=64), decoder=tiny_decoder(**kw))


def lm_params(dec, seed=0):
    """Seeded random weights, the norm scales moved off 1 so that a norm
    left out would show."""
    g = torch.Generator().manual_seed(seed)
    p = D.init(dec, torch.float32, device="cpu", generator=g)
    for lp in p["layers"]:
        for k in ("input_norm_w", "kv_norm_w", "post_norm_w"):
            lp[k] = 1 + 0.1 * torch.randn(lp[k].shape, generator=g)
        for k in ("q", "kv_a", "kv_b", "o"):  # wider weights: attention that is not flat
            lp[k] = lp[k] * 5
    p["final_norm_w"] = 1 + 0.1 * torch.randn(dec.hidden_size, generator=g)
    return p


def _close(got, want, rtol=RTOL):
    return torch.allclose(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


def test_config_from_json_reads_deepseek_v2(tmp_path):
    import json
    d = json.load(open("portbench/configs/vibevoice-dsv2-lite.json"))
    path = tmp_path / "c.json"
    path.write_text(json.dumps(d))
    cfg = C.config_from_json(str(path))
    assert cfg.decoder == C.DeepseekV2Config()
    assert V.decoder_module(cfg.decoder) is D
    d["decoder_config"]["q_lora_rank"] = 1536
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="q_lora_rank"):
        C.config_from_json(str(path))


def test_yarn_cos_sin_equal_the_formula():
    """DeepSeek-V2-Lite's YaRN, from modeling_deepseek.py's formulas written
    out here: the ramp between dims 10 and 23 of the 32 frequencies, the
    mscale 0.1 * 0.707 * ln 40 + 1 and the softmax scale m^2 / sqrt(192)."""
    dec = C.DeepseekV2Config()
    dim, base = 64, 10000.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = base ** (-2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    inv = D.yarn_inv_freq(dec)
    assert torch.allclose(inv, torch.tensor(want, dtype=torch.float32), rtol=1e-6)
    assert torch.equal(inv, RD.inv_freq(ref_decoder(dec)))
    pos = torch.tensor([[0, 1, 4095, 4096, 45055, 53247]])
    cos, sin = D.rope_cos_sin(pos, dec)
    ang = pos[0].double()[:, None] * torch.tensor(want, dtype=torch.float64)
    ang = torch.cat([ang, ang], dim=-1)
    # the cos/sin factor mscale / mscale_all_dim is 1; fp32 angles to 53k rad
    assert torch.allclose(cos[0].double(), ang.cos(), atol=1e-2)
    assert torch.allclose(sin[0].double(), ang.sin(), atol=1e-2)
    rc, rs = RD.rope_cos_sin(pos[0], ref_decoder(dec))
    assert torch.equal(cos[0], rc) and torch.equal(sin[0], rs)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert D.softmax_scale(dec) == pytest.approx(m * m / math.sqrt(192), rel=1e-12)
    assert RD.softmax_scale(ref_decoder(dec)) == pytest.approx(D.softmax_scale(dec), rel=1e-12)


def test_rope_pairs_are_the_interleaved_layout():
    """The rope part is read as interleaved pairs (x0, x1), (x2, x3), ...:
    rotating by angle a turns each pair as a complex number."""
    dec = tiny_decoder()
    x = torch.randn(1, 1, 1, 16, generator=torch.Generator().manual_seed(3))
    cos, sin = D.rope_cos_sin(torch.tensor([[5]]), dec)
    got = D.apply_rope(x, cos, sin)[0, 0, 0]
    ang = 5 * D.yarn_inv_freq(dec)
    z = torch.complex(x[0, 0, 0, 0::2], x[0, 0, 0, 1::2]) * torch.polar(torch.ones(8), ang)
    assert torch.allclose(got, torch.cat([z.real, z.imag]), atol=1e-6)


def _tied_router(lp, h0):
    """Router columns 2, 5 and 6 equal and turned to the token h0: for it
    the three tie at the top, one more than the top-2 takes."""
    lp["router"][:, [2, 5, 6]] = (3 * h0 / h0.norm())[:, None]
    return lp


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_moe_equals_a_per_expert_loop(monkeypatch, path):
    """The port's expert layer, in the step's dense form (every expert,
    weighed by the gate matrix) and the prompt's sparse form, against the
    reference's loop over each token's experts, with ties in the router and
    the top-k weights left unnormalised."""
    dec = tiny_decoder()
    p = lm_params(dec)
    h = torch.randn(40, dec.hidden_size, generator=torch.Generator().manual_seed(4))
    h[:20] = h[0]  # identical tokens, each with a three-way tie at the top
    lp = _tied_router(p["layers"][1], h[0])
    if path == "sparse":
        monkeypatch.setattr(D, "DENSE_MAX_TOKENS", 0)
        monkeypatch.setattr(D, "PREFILL_CHUNK", 16)
    got = D.moe(lp, dec, h)
    want = RD.moe(lp, ref_decoder(dec), h)
    assert _close(got, want)
    sel, w = D.route(lp, dec, h)
    ids, rw = RD.route(lp, ref_decoder(dec), h)
    assert torch.equal(sel, torch.zeros_like(sel).scatter_(1, ids, True))
    assert torch.equal(w.gather(1, ids), rw)
    assert (sel.sum(dim=1) == 2).all() and (w.sum(dim=1) < 0.999).all()  # not renormalised
    scores = torch.softmax(h @ lp["router"], dim=-1)
    assert (scores[:20, 2] == scores[:20, 6]).all()
    assert (sel[:20, 2] & sel[:20, 5] & ~sel[:20, 6]).all()  # a tie goes to the lower index


def test_absorbed_decode_equals_the_published_form():
    """The latent cache read in the absorbed form (dense with a causal bias,
    and through the kernel's plain version) against the published form over
    the same tokens."""
    dec = tiny_decoder()
    p = lm_params(dec, seed=1)
    g = torch.Generator().manual_seed(5)
    t = 11
    x = torch.randn(2, t, dec.hidden_size, generator=g)
    mask = torch.ones(2, t, dtype=torch.int32)
    pos = D.positions_from_mask(mask)
    bias = D.causal_bias(mask, t)
    want, _ = D.forward(p, dec, x, pos, bias)  # no cache: the published form
    cache = D.kv_cache_init(dec, 2, t)
    got, _ = D.forward(p, dec, x, pos, bias, cache=cache, write_pos=0)  # absorbed, dense
    assert _close(got, want)
    # one token more through the kernel route against the whole sequence
    y = torch.randn(2, 1, dec.hidden_size, generator=g)
    cache = D.kv_cache_init(dec, 2, t + 1)
    D.forward(p, dec, x, pos, None, cache=cache, write_pos=0, pad_mask=mask, use_flash=True)
    vis = torch.ones(2, t + 1, dtype=torch.int32)
    lengths = torch.full((2,), t + 1, dtype=torch.int32)
    step, _ = D.forward(p, dec, y, torch.full((2, 1), t), None, cache=cache, write_pos=t,
                        decode_ctx=(vis, lengths))
    whole, _ = D.forward(p, dec, torch.cat([x, y], 1), D.positions_from_mask(
        torch.ones(2, t + 1, dtype=torch.int32)), D.causal_bias(torch.ones(2, t + 1), t + 1))
    assert _close(step[:, 0], whole[:, -1])


def test_prefill_and_decode_through_the_latent_cache_match_the_reference():
    """A left-padded prompt prefilled into the latent cache (the published
    form over each row's real tokens), then three decode steps through the
    cache (the kernel route), against the reference's full forward over the
    whole sequence: the hidden states, the cache's slots, and the logits
    over the allowed tokens of the untied head."""
    dec = tiny_decoder()
    rdec = ref_decoder(dec)
    p = lm_params(dec, seed=2)
    g = torch.Generator().manual_seed(6)
    head = 0.05 * torch.randn(dec.hidden_size, dec.vocab_size, generator=g)
    allowed = [7, 100, 250, 319]
    t, s = 13, 20
    x = torch.randn(2, t, dec.hidden_size, generator=g)
    mask = torch.ones(2, t, dtype=torch.int32)
    mask[1, :4] = 0
    cache = D.kv_cache_init(dec, 2, s)
    h, cache = D.forward(p, dec, x, D.positions_from_mask(mask), None, cache=cache, write_pos=0,
                         pad_mask=mask, use_flash=True)
    seqs = [x[0], x[1, 4:]]
    for r in range(2):
        want_h, want_lat = RD.lm_prompt(p, rdec, [seqs[r]], block=4)
        n = seqs[r].shape[0]
        assert _close(h[r, -1], want_h[0])
        assert _close(cache.latent[:, r, t - n:t], want_lat[0])
    vis = torch.zeros(2, s, dtype=torch.int32)
    vis[:, :t] = mask
    for i in range(3):
        y = torch.randn(2, 1, dec.hidden_size, generator=g)
        wp = t + i
        vis[:, wp] = 1
        lengths = torch.full((2,), wp + 1, dtype=torch.int32)
        pos = (vis.sum(dim=1, keepdim=True) - 1)
        hy, _ = D.forward(p, dec, y, pos, None, cache=cache, write_pos=wp,
                          decode_ctx=(vis.clone(), lengths))
        for r in range(2):
            seqs[r] = torch.cat([seqs[r], y[r]])
            want_h, want_lat = RD.lm_prompt(p, rdec, [seqs[r]], block=4)
            assert _close(hy[r, 0], want_h[0])
            assert _close(cache.latent[:, r, wp], want_lat[0][:, -1])
            got_l = (hy[r, 0] @ head)[allowed]
            assert _close(got_l, (want_h[0] @ head)[allowed])
    # one step of the reference from the cached slots (as the benchmark's
    # check reads the program's cache) agrees as well
    past = [cache.latent[:, r, torch.nonzero(vis[r])[:-1, 0]] for r in range(2)]
    ref_h, _ = RD.lm_step(p, rdec, y[:, 0], pos[:, 0].tolist(),
                          lambda li, j: past[j][li])
    assert _close(hy[:, 0], ref_h)


def _engine(cfg, p, **kw):
    gen = G.GenerationConfig(speech_start_id=250, speech_end_id=251, speech_diffusion_id=252,
                             eos_id=253, force_diffusion=True, ddpm_steps=3)
    return G.Engine(p, cfg, gen, max_steps=8, batch=2, prompt_len=12, device="cpu",
                    inject_latent_noise=True, **kw)


def _params(cfg):
    p = V.init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p["speech_scaling_factor"] = torch.tensor(0.8)
    p["speech_bias_factor"] = torch.tensor(0.1)
    return p


def _inputs():
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 240, (2, 12), generator=g)
    mask = torch.ones(2, 12, dtype=torch.int32)
    mask[1, :3] = 0
    return ids, mask, torch.zeros(2, 12, dtype=torch.bool), torch.randn(8, 2, 8, generator=g)


def test_engine_prefill_and_eager_steps():
    """The engine chooses the decoder from the configuration, prefills into
    the latent cache and steps; the kernel route and the dense bias route
    give the same audio, and the untied head's logits subset is used."""
    cfg = tiny_vibevoice()
    p = _params(cfg)
    ids, mask, sm, noise = _inputs()
    audio = []
    for flash in (False, True):
        eng = _engine(cfg, p, use_flash_decode=flash)
        assert eng.lm is D and eng.use_flash_prefill
        st, out = eng.prefill(ids, mask, sm, latent_noise=noise)
        assert isinstance(st.cache, D.LatentCache)
        assert st.cache.latent.shape[:3] == (3, 4, eng.cache_len)
        st, outs = eng.decode_chunk(st, 4)
        assert torch.isfinite(outs.audio_chunk).all() and bool(outs.emitted.all())
        audio.append(outs.audio_chunk)
    assert torch.allclose(audio[0], audio[1], rtol=1e-4, atol=1e-7)
    res = G.generate(_engine(cfg, p), ids, mask, sm, latent_noise=noise)
    assert res.steps == 8 and all(a is not None for a in res.audio)


def test_engine_tracer_records_the_lm_sub_parts_and_the_experts_hit():
    cfg = tiny_vibevoice()
    eng = _engine(cfg, _params(cfg))
    ids, mask, sm, noise = _inputs()
    tr = Tracer()
    eng.set_tracer(tr)
    st, _ = eng.prefill(ids, mask, sm, latent_noise=noise)
    eng.decode_chunk(st, 3)
    names = {s.name for s in tr.spans}
    assert {"lm", "lm.mla", "lm.moe", "lm.mlp"} <= names
    per_step = [s for s in tr.spans if s.name == "lm.mla"]
    assert len(per_step) == 3 * 3  # three steps of three layers
    lm = sum(s.ns for s in tr.spans if s.name == "lm")
    assert sum(s.ns for s in tr.spans if s.name in ("lm.mla", "lm.moe", "lm.mlp")) <= lm
    c = tr.counters
    assert c["moe.layer_steps"] == 3 * 2  # three steps of two expert layers
    assert 2 * 2 <= c["moe.experts_hit"] <= 3 * 2 * 8  # 4 rows x top-2 of 8, per layer-step


def test_engine_refuses_what_is_not_ported():
    cfg = tiny_vibevoice()
    p = _params(cfg)
    with pytest.raises(ValueError, match="int8 KV"):
        _engine(cfg, p, kv_dtype="int8")
    for mode in ("int8", "int4"):
        q = dict(p, lm=_quantized_lm(p, mode))
        with pytest.raises(ValueError, match="int8/int4"):
            _engine(cfg, q)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="tensor parallelism"):
        _engine(cfg, p, mesh=mesh)
    with pytest.raises(ValueError, match="tensor parallelism"):
        D.forward(p["lm"], cfg.decoder, torch.zeros(1, 1, 64), torch.zeros(1, 1), None,
                  mesh=mesh)
    with pytest.raises(NotImplementedError):
        V.training_forward(p, cfg, *([None] * 9))


def _quantized_lm(p, mode):
    """The LM with its first layer's q projection quantized as the port's
    weight modes store it."""
    from vibevoice_tpu_torch.utils import quantize as Q
    lm = dict(p["lm"], layers=list(p["lm"]["layers"]))
    lm["layers"][0] = dict(lm["layers"][0])
    w = lm["layers"][0]["q"]
    lm["layers"][0]["q"] = (Q.quantize_weight(w) if mode == "int8"
                            else Q.quantize_weight_int4(w))
    return lm


def test_untraced_engine_adds_no_marks_or_tally():
    """Untraced, the DeepSeek-V2 step passes no mark and no tally to the
    decoder: its graph is what it is without a tracer."""
    cfg = tiny_vibevoice()
    eng = _engine(cfg, _params(cfg))
    ids, mask, sm, noise = _inputs()
    seen = []
    real = D.forward

    def spy(*a, **k):
        seen.append((k.get("mark"), k.get("tally")))
        return real(*a, **k)
    D.forward = spy
    try:
        st, _ = eng.prefill(ids, mask, sm, latent_noise=noise)
        eng.decode_chunk(st, 2)
    finally:
        D.forward = real
    assert len(seen) == 4 and all(m is None and t is None for m, t in seen)
