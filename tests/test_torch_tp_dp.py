"""The port's tensor- and data-parallel engines (`Engine(mesh=...)`) on gloo
ranks against the JAX package's TP and DP engines on the virtual CPU mesh and
against the unsharded engines: the tiny fp32 model of `test_torch_engine.py`
(its subset head, prompts, voice latents and injected diffusion noise).

* TP=2 (`make_mesh(model=2)` on both sides; the port's ranks hold
  `parallel.shard_params` shards, eager over gloo): plain, flash prefill and
  decode attention forced on (the JAX kernels in interpret mode, the port's
  plain versions), int8 weights, and int8 KV.  Tokens equal; audio within
  1e-4.  The int8 KV scales equal the unsharded cache's bit for bit, and
  differ without the amax reduction over the model group.
* The collectives of one TP step, counted by wrapping `torch.distributed` in
  the ranks (the counterpart of `test_tp_decode_step_hlo_has_no_cache_
  allgather`): exactly the all-reduces the split needs, nothing gathered,
  none above a few KB.
* DP=2 on the global batch of 4 ragged rows: the gathered rows and
  `generate`'s result against the JAX DP engine on `make_mesh(data=2)` and
  the unsharded one; no collective in a step.
* DP=2 with the fused large-T stages at global B=2 and B=4: the gathered
  rows against the JAX DP engine's, and each rank's stage packs (folded
  conv, row-lane row group) equal to the JAX DP engine's, which the policies
  choose from the global batch.  At B=4 the row group (4) does not divide a
  rank's 2 rows, which then take the plain stage path.
* The refusals, with the JAX engine's exception types.
"""
import numpy as np
import pytest

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.parallel import mesh as JM
from vibevoice_tpu.utils.quantize import quantize_model
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.parallel.mesh import Mesh

from tests._torch_parity import to_np
from tests._torch_ranks import (GEN, Ranks, dp_program, dp_stages_program, save_tree,
                                stage_packs_summary, tp_program)
from tests.test_torch_engine import STEPS, _inputs, _params

FLASH = dict(use_flash_prefill=True, use_flash_decode=True)
TP_CASES = [("plain", "weights.npz", {}),
            ("flash", "weights.npz", FLASH),
            ("int8", "weights_int8.npz", FLASH),
            ("int8kv", "weights.npz", dict(use_flash_decode=True, kv_dtype="int8"))]
FIELDS = ("tokens", "audio", "emitted", "frames", "finished", "reach_max")
STAGE_BATCHES = (2, 4)


def _jax_run(params, cfg, inputs, mesh=None, **kw):
    ids, mask, sim, fmask, vl, noise = inputs
    b, t = ids.shape
    je = JG.Engine(params, cfg, JG.GenerationConfig(**GEN), max_steps=STEPS, batch=b,
                   prompt_len=t, inject_latent_noise=True, mesh=mesh, **kw)
    state, _ = je.prefill(ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                          latent_noise=noise)
    state, _ = je.decode_chunk(state, STEPS - 1)
    return je, {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _dp_inputs():
    """Four rows, two of them left-padded, one voice of three frames each (a
    DP rank's rows carry their own voices)."""
    rng = np.random.default_rng(1)
    b, t = 4, 24
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    ids[:, -1] = 258
    mask = np.ones((b, t), np.int32)
    mask[1, :5] = 0
    mask[3, :3] = 0
    sim = np.zeros((b, t), bool)
    fmask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]], bool)
    for r, start in enumerate((4, 8, 6, 5)):
        sim[r, start:start + fmask[r].sum()] = True
    vl = rng.normal(size=(b, 3, 8)).astype(np.float32)
    noise = rng.normal(size=(STEPS, b, 8)).astype(np.float32)
    return ids, mask, sim, fmask, vl, noise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two TP ranks and one of two DP ranks (started first, so
    the ranks run while this process makes the JAX references)."""
    cfg, jp, _ = _params()
    work = tmp_path_factory.mktemp("tp_dp")
    jq = quantize_model(jp, cfg.decoder.tie_word_embeddings, mode="int8")
    save_tree(work / "weights.npz", to_np(jp))
    save_tree(work / "weights_int8.npz", to_np(jq))
    save_tree(work / "inputs.npz", list(_inputs()))
    save_tree(work / "dp_inputs.npz", list(_dp_inputs()))
    tp = Ranks(tp_program, 2, work, str(work), TP_CASES, STEPS, timeout=300)
    dp = Ranks(dp_program, 2, work, str(work), STEPS, {}, timeout=300)
    dps = Ranks(dp_stages_program, 2, work, str(work), STEPS, STAGE_BATCHES, timeout=300)

    tp_mesh = JM.make_mesh(data=1, model=2)
    trees = {"weights.npz": jp, "weights_int8.npz": jq}
    jax_tp = {}
    for name, weights, kw in TP_CASES:
        je, jax_tp[name] = _jax_run(JM.shard_params(trees[weights], tp_mesh, cfg=cfg), cfg,
                                    _inputs(), **kw)
        assert je.mesh is tp_mesh
    _, jax_plain = _jax_run(jp, cfg, _inputs())
    dp_mesh = JM.make_mesh(data=2, model=1)
    je, jax_dp = _jax_run(JM.shard_params(jp, dp_mesh, cfg=cfg), cfg, _dp_inputs(),
                          mesh=dp_mesh)
    assert je.dp_mesh is dp_mesh
    _, jax_dp_ref = _jax_run(jp, cfg, _dp_inputs())
    jax_stages = {}
    for b in STAGE_BATCHES:
        rows = [a[:b] for a in _dp_inputs()[:5]] + [_dp_inputs()[5][:, :b]]
        je, got = _jax_run(JM.shard_params(jp, dp_mesh, cfg=cfg), cfg, rows, mesh=dp_mesh,
                           use_fused_stages=True, fused_stage_t_min=7)
        jax_stages[b] = dict(got, packs=stage_packs_summary(je.params))
    return dict(cfg=cfg, tp=tp.results(), dp=dp.results(), jax_tp=jax_tp,
                jax_plain=jax_plain, jax_dp=jax_dp, jax_dp_ref=jax_dp_ref,
                dp_stages=dps.results(), jax_dp_stages=jax_stages)


def _assert_rows_match(got, want, what):
    for k in ("tokens", "emitted", "frames", "finished", "reach_max"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
    assert want["emitted"].any() and np.abs(want["audio"]).max() > 1e-2
    np.testing.assert_allclose(got["audio"], want["audio"], atol=1e-4, rtol=0,
                               err_msg=f"{what}: audio")


@pytest.mark.parametrize("case", [c[0] for c in TP_CASES])
def test_tp_engine_matches_jax(runs, case):
    """Both ranks give the JAX TP engine's tokens and audio, and the
    unsharded engines' (the JAX one for the plain case, the port's for every
    case); the cache holds the rank's (KVH/2)*D lanes."""
    for r, out in enumerate(runs["tp"]):
        got = out[case]
        _assert_rows_match(got, runs["jax_tp"][case], f"rank {r} vs the JAX TP engine")
        _assert_rows_match(got, runs["tp"][0][case]["unsharded"],
                           f"rank {r} vs the port's unsharded engine")
        if case == "plain":
            _assert_rows_match(got, runs["jax_plain"], f"rank {r} vs the JAX engine")
        dec = runs["cfg"].decoder
        assert got["cache_lanes"] == dec.num_key_value_heads // 2 * dec.head_dim


def test_tp_int8_kv_scales_need_the_amax_reduction(runs):
    """Each rank's stored slot scales equal the unsharded int8 cache's bit for
    bit; with the per-slot amax reduction over the model group removed they
    differ (each rank scales its own lanes), so this check fails without it."""
    ref = runs["tp"][0]["int8kv"]["unsharded"]
    for r, out in enumerate(runs["tp"]):
        got = out["int8kv"]
        for k in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"rank {r} {k}")
            assert not np.array_equal(got["no_amax_reduce"][k], ref[k]), f"rank {r} {k}"


@pytest.mark.parametrize("case", ["plain", "int8kv"])
def test_tp_step_collectives(runs, case):
    """One TP step: an all-reduce of the o and down outputs per layer, of the
    head's FFN per solver step and head layer, and with int8 KV one of the k
    and v slot amaxes per layer; no gather of any kind, none above 4 KB."""
    cfg = runs["cfg"]
    layers = cfg.decoder.num_hidden_layers
    want = 2 * layers + GEN["ddpm_steps"] * cfg.diffusion_head.head_layers
    if case == "int8kv":
        want += layers
    for out in runs["tp"]:
        counts = out[case]["counts"]
        assert set(counts) == {"all_reduce"}, counts
        assert len(counts["all_reduce"]) == want, counts
        assert max(counts["all_reduce"]) <= 4096, counts


def test_tp_logits_subset_is_whole_on_every_rank(runs):
    """The int8 tree's lm_head (embed^T) is split by column over the two
    ranks; the engine's allowed-token subset is the unsharded one on both."""
    vocab = runs["cfg"].decoder.vocab_size
    for out in runs["tp"]:
        assert out["head_subset"]["split_width"] == vocab // 2
        assert out["head_subset"]["equal"]


def test_tp_refusals_on_a_live_group(runs):
    """Over gloo a TP engine must be eager (its step cannot be captured), and
    params that are not the rank's shard do not fit a TP mesh: both
    ValueError, as the JAX engine's shape errors are."""
    for out in runs["tp"]:
        ref = out["refusals"]
        assert ref["gloo_graph"][0] == "ValueError" and "eager=True" in ref["gloo_graph"][1]
        assert ref["unsharded_params"][0] == "ValueError"
        assert "shard" in ref["unsharded_params"][1]


def test_dp_engine_matches_jax(runs):
    """Each rank served 2 of the 4 rows; the gathered rows equal the JAX DP
    engine's and the unsharded JAX engine's."""
    for r, out in enumerate(runs["dp"]):
        assert out["local_batch"] == 2
        _assert_rows_match(out["gathered"], runs["jax_dp"], f"rank {r} vs the JAX DP engine")
        _assert_rows_match(out["gathered"], runs["jax_dp_ref"], f"rank {r} vs the JAX engine")


@pytest.mark.parametrize("b", STAGE_BATCHES)
def test_dp_fused_stages_match_jax(runs, b):
    """DP=2 with the fused stages at global B=2 and B=4: each rank's packs
    fold no conv and carry the row-lane row group of the JAX DP engine's,
    which reads the global batch (a rank's own rows would fold the convs at
    B=2 and take row groups of 2 at B=4), and the gathered rows equal the
    JAX DP engine's (tokens equal, audio within 1e-4)."""
    want = runs["jax_dp_stages"][b]
    assert not any(fold for packs in want["packs"].values() for fold, _ in packs.values())
    assert {r for packs in want["packs"].values() for _, r in packs.values()} == {b}
    for r, out in enumerate(runs["dp_stages"]):
        got = out[b]
        assert got["local_batch"] == b // 2
        assert got["packs"] == want["packs"], f"rank {r}"
        _assert_rows_match(got["gathered"], want, f"rank {r}, B={b} vs the JAX DP engine")


def test_dp_step_makes_no_collective(runs):
    for out in runs["dp"]:
        assert out["counts"] == {}, out["counts"]


def test_dp_generate_is_global(runs):
    """`generate` on a DP engine (a streamer attached) stops when every
    rank's rows finished and returns every row, in global order: the
    gathered state's tokens and audio, on both ranks."""
    want = runs["jax_dp_ref"]
    for out in runs["dp"]:
        res = out["generate"]
        np.testing.assert_array_equal(res["tokens"], want["tokens"][:, :res["tokens"].shape[1]])
        assert res["tokens"].shape[0] == 4
        for i, a in enumerate(res["audio"]):
            w = want["audio"][i][want["emitted"][i]].reshape(-1)
            np.testing.assert_allclose(a, w, atol=1e-4, rtol=0)
        assert out["odd_batch"][0] == "ValueError"


def test_dp_streamer_gets_global_rows(runs):
    """Each rank's streamer got only its own rows, under their global
    indices, each equal to that row's returned audio."""
    want = runs["jax_dp_ref"]
    for r, out in enumerate(runs["dp"]):
        streamed = out["generate"]["streamed"]
        assert set(streamed) == {i for i in (2 * r, 2 * r + 1) if want["emitted"][i].any()}
        assert streamed
        for i, chunks in streamed.items():
            np.testing.assert_array_equal(chunks, out["generate"]["audio"][i])


def test_dp_generate_stops_on_one_ranks_stop_check(runs):
    """Rank 0's `stop_check_fn` fires before its second chunk and rank 1's
    never: both ranks end on that chunk (no collective left unmatched) and
    return the same rows, the unstopped run's first tokens."""
    want = runs["jax_dp_ref"]
    got = [out["stopped"] for out in runs["dp"]]
    assert got[0]["steps"] == got[1]["steps"] == 2
    assert runs["dp"][0]["generate"]["steps"] > 2
    for res in got:
        n = res["tokens"].shape[1]
        assert res["tokens"].shape[0] == 4 and n <= 2
        np.testing.assert_array_equal(res["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(res["tokens"], want["tokens"][:, :n])


def test_mesh_refusals_match_jax():
    """A data x model mesh raises NotImplementedError and KV heads that do not
    split over the model axis raise ValueError, before any collective (mesh
    objects of a rank, with no group), as the JAX engine raises."""
    _, _, tp = _params()
    cfg, gen = TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN)
    base = dict(max_steps=4, batch=4, prompt_len=8, device="cpu", eager=True)
    with pytest.raises(NotImplementedError):
        TG.Engine(tp, cfg, gen, **base, mesh=Mesh(2, 2, rank=0, groups={}))
    with pytest.raises(ValueError, match="num_key_value_heads"):
        TG.Engine(tp, cfg, gen, **base, mesh=Mesh(1, 4, rank=0, groups={}))
    with pytest.raises(ValueError, match="divide over data axis"):
        TG.Engine(tp, cfg, gen, **dict(base, batch=3), mesh=Mesh(2, 1, rank=0, groups={}))
