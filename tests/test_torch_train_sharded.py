"""The port's sharded training step (`make_train_step(mesh=)`) on gloo ranks
against the JAX package's step.

* data=2 x model=2 on four ranks (`tiny_config`, KVH=2): two AdamW steps on
  a global batch of four rows whose two data ranks hold different label
  counts, clip counts and masked-out frames, against the JAX step jitted on
  `make_mesh(data=2, model=2)` (conftest's virtual devices) with
  `shard_params` and the row arrays on `batch_specs` (the clip arrays,
  7 rows, replicated): the losses of both steps and every gathered leaf
  after them, and the q shard still half of the columns.
* model=2 alone, one backward, tied and untied `lm_head`: every leaf's
  gathered gradient against `jax.grad` of the unsharded loss, the whole
  (replicated) leaves' gradients equal on both ranks (which needs the
  backward sums of `parallel.autograd.copy_to`), and the optimizer's global
  norm against `optax.global_norm`.
* The scaling statistics averaged over the data group: against the JAX
  `compute_scaling_stats(axis_name="data")` under `shard_map` with equal
  shares, and against the JAX statistics of each share averaged in numpy
  with unequal ones (also through `init_scaling_stats` on the real shares).
* `data.shard_batch`'s clips and `train.injected_rows` against the global
  packed order (no ranks).

fp32 on both sides with injected noise and timesteps; a leaf agrees within
REL of its largest magnitude, as in `test_torch_train.py`.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from vibevoice_tpu import data as JD, train as JT
from vibevoice_tpu.models import vibevoice as JV
from vibevoice_tpu.parallel import mesh as JM
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer
from vibevoice_tpu_torch import data as TD, train as TT
from vibevoice_tpu_torch.parallel.mesh import Mesh

from tests._torch_parity import tiny_params, to_np
from tests._torch_ranks import Ranks, save_tree, train_grad_program, train_step_program
from tests.test_torch_train import REL, _close, _cfgs, _tables

MUL = 4
STEPS = 2
LR = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _batch():
    """Four examples (hop 16, clips of up to 3 frames): data rank 0 takes
    rows 0-1 with three clips, rank 1 rows 2-3 with four; each rank has
    masked-out frames and its own count of labels."""
    rng = np.random.default_rng(5)
    examples = [
        ([(1, " Hello there."), (2, " Hi.")], [rng.normal(0, 0.1, 40), rng.normal(0, 0.1, 16)]),
        ([(1, " Short.")], [rng.normal(0, 0.1, 20)]),
        ([(2, " A much longer line of text.")], [rng.normal(0, 0.1, 48)]),
        ([(1, " One."), (2, " Two two."), (1, " Three.")],
         [rng.normal(0, 0.1, 16), rng.normal(0, 0.1, 36), rng.normal(0, 0.1, 8)]),
    ]
    sem_rng = np.random.default_rng(6)
    sem_fn = lambda s: sem_rng.normal(0, 0.1, (s.shape[0], s.shape[1] // 16, 16)).astype(
        np.float32)
    return JD.build_training_batch(ByteFallbackTokenizer(), examples, hop=16,
                                   semantic_fn=sem_fn, semantic_dim=16)


def _noise(batch, seed):
    n = batch.speech_masks.size * MUL
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 8)).astype(np.float32), rng.integers(0, 100, n).astype(np.int32)


def _jax_params(untied):
    jcfg, _ = _cfgs()
    _, jp = tiny_params()
    if not untied:
        return jcfg, jp
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder,
                                                                 tie_word_embeddings=False))
    w = np.random.default_rng(8).normal(0, 0.02, (jcfg.decoder.hidden_size,
                                                  jcfg.decoder.vocab_size))
    return jcfg, dict(jp, lm_head=jnp.asarray(w.astype(np.float32)))


def _jax_loss(jcfg, batch, noise, t):
    b = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss(params):
        out = JV.training_forward(
            params, jcfg, _tables(), jax.random.PRNGKey(0), input_ids=b.input_ids,
            attention_mask=b.attention_mask, speech_tensors=b.speech_tensors,
            speech_masks=b.speech_masks, speech_semantic_tensors=b.speech_semantic_tensors,
            acoustic_input_mask=b.acoustic_input_mask, acoustic_loss_mask=b.acoustic_loss_mask,
            labels=b.labels, ddpm_batch_mul=MUL, injected_noise=jnp.asarray(noise),
            injected_timesteps=jnp.asarray(t))
        return out.ce_loss + out.diffusion_loss
    return loss


def _stats_inputs():
    """Latents [4, 5, 8] and masks with masked-out frames: equal shares (two
    rows each) and unequal ones (three rows and one)."""
    rng = np.random.default_rng(9)
    lat = rng.normal(0.3, 2.0, size=(4, 5, 8)).astype(np.float32)
    mask = np.ones((4, 5), bool)
    mask[1, 3:] = False
    mask[3, 1:] = False
    return lat, mask, {"equal": [(lat[:2], mask[:2]), (lat[2:], mask[2:])],
                       "unequal": [(lat[:3], mask[:3]), (lat[3:], mask[3:])]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of four data x model ranks and one of two model ranks (both
    started first, so they run while this process makes the JAX
    references)."""
    work = tmp_path_factory.mktemp("train_sharded")
    batch = _batch()
    save_tree(work / "batch.npz", list(batch))
    for i in range(STEPS):
        save_tree(work / f"noise{i}.npz", list(_noise(batch, 20 + i)))
    for name, untied in (("tied", False), ("untied", True)):
        save_tree(work / f"weights_{name}.npz", to_np(_jax_params(untied)[1]))
    save_tree(work / "stats.npz", {k: [list(s) for s in v]
                                   for k, v in _stats_inputs()[2].items()})
    step_ranks = Ranks(train_step_program, 4, work, str(work), 2, 2, MUL, STEPS, timeout=240)
    grad_ranks = Ranks(train_grad_program, 2, work, str(work), MUL, timeout=240)

    # the JAX step, jitted on the data x model mesh
    jcfg, jp = _jax_params(False)
    mesh = JM.make_mesh(data=2, model=2)
    jopt = JT.make_optimizer(**LR)
    params = JM.shard_params(jp, mesh, cfg=jcfg)
    state = jax.jit(jopt.init)(params)

    def put(a):
        a = jnp.asarray(a)
        spec = P("data", *([None] * (a.ndim - 1))) if a.shape[0] % 2 == 0 else P()
        return jax.device_put(a, NamedSharding(mesh, spec))

    @jax.jit
    def jax_step(params, state, b, noise, t):
        loss, grads = jax.value_and_grad(_jax_loss(jcfg, b, noise, t))(params)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    sharded_batch = JT.TrainBatch(*(put(a) for a in batch))
    losses = []
    for i in range(STEPS):
        params, state, loss = jax_step(params, state, sharded_batch, *_noise(batch, 20 + i))
        losses.append(float(loss))
    assert len(params["lm"]["layers"][0]["q"]["w"].sharding.device_set) == 4

    grads = {}
    noise, t = _noise(batch, 20)
    for name, untied in (("tied", False), ("untied", True)):
        gcfg, gp = _jax_params(untied)
        grads[name] = jax.grad(_jax_loss(gcfg, batch, noise, t))(gp)
    return dict(batch=batch, step=step_ranks.results(), grad=grad_ranks.results(),
                jax_losses=losses, jax_params=jax.tree_util.tree_leaves(params),
                jax_grads=grads)


def _gather(per_rank, dims):
    """Leaf i of each model rank, concatenated along its split dimension."""
    return [per_rank[0][i] if d is None else np.concatenate([r[i] for r in per_rank], axis=d)
            for i, d in enumerate(dims)]


def test_dp_tp_two_steps_match_jax(runs):
    """Every rank reports the JAX step's loss at both steps; every leaf,
    gathered over the model ranks of each data rank, is the JAX tree's after
    two steps; the q shard is still half of the columns."""
    step = runs["step"]
    for r, out in enumerate(step):
        for i, m in enumerate(out["metrics"]):
            np.testing.assert_allclose(m["loss"], runs["jax_losses"][i], rtol=REL,
                                       err_msg=f"rank {r} step {i}")
            np.testing.assert_allclose(m["loss"], m["ce_loss"] + m["diffusion_loss"], rtol=1e-6)
    dims = step[0]["dims"]
    for d in (0, 1):
        got = _gather([step[2 * d]["leaves"], step[2 * d + 1]["leaves"]], dims)
        assert len(got) == len(runs["jax_params"])
        for g, w in zip(got, runs["jax_params"]):
            _close(g, np.asarray(w))


def test_q_shard_keeps_half_the_columns(runs):
    """After the steps each rank's layer-0 q shard has half of the q
    projection's columns (the JAX step keeps q split over `model`)."""
    jcfg, _ = _cfgs()
    dec = jcfg.decoder
    for out in runs["step"]:
        assert out["q_width"] == dec.num_attention_heads * dec.head_dim // 2


def test_data_ranks_hold_unequal_shares(runs):
    """The two data ranks hold different label counts, clip counts and
    masked-out frames: the case a mean of per-rank means gets wrong."""
    batch = runs["batch"]
    owners = TD.clip_owners(batch)
    labels = [(batch.labels[rows] != -100).sum() for rows in (slice(0, 2), slice(2, 4))]
    clips = [np.flatnonzero(owners // 2 == d) for d in (0, 1)]
    masked = [(~batch.speech_masks[c]).sum() for c in clips]
    assert labels[0] != labels[1] and len(clips[0]) != len(clips[1])
    assert masked[0] != masked[1] and min(masked) > 0
    for r, out in enumerate(runs["step"]):
        np.testing.assert_array_equal(out["clips"], clips[r // 2])
        assert out["rows"] == 2


@pytest.mark.parametrize("head", ["tied", "untied"])
def test_model_split_gradients_match_jax(runs, head):
    """One backward on model=2: every leaf's gradient, gathered over the two
    ranks, against `jax.grad` (the leaves autograd leaves without one are
    zero in JAX); the whole leaves' gradients are equal on both ranks; the
    logits come back whole."""
    per = [r[head] for r in runs["grad"]]
    dims = per[0]["dims"]
    jgrads = jax.tree_util.tree_leaves(runs["jax_grads"][head])
    assert len(dims) == len(jgrads) and any(d is not None for d in dims)
    vocab = _cfgs()[0].decoder.vocab_size
    for out in per:
        assert out["logits"].shape[-1] == vocab
    n_none = 0
    for i, (d, w) in enumerate(zip(dims, jgrads)):
        w = np.asarray(w)
        g = [out["grads"][i] for out in per]
        if g[0] is None:
            assert g[1] is None and not w.any()
            n_none += 1
            continue
        if d is None:
            np.testing.assert_array_equal(g[0], g[1], err_msg=f"leaf {i}")
            _close(g[0], w)
        else:
            _close(np.concatenate(g, axis=d), w)
    assert n_none > 0
    if head == "untied":  # the untied head is one more leaf, split by column
        tied = runs["grad"][0]["tied"]["dims"]
        assert len(dims) == len(tied) + 1 and dims.count(1) == tied.count(1) + 1


def test_global_norm_matches_optax(runs):
    """The optimizer's global norm (model-split leaves summed over the
    group, whole leaves once) is `optax.global_norm` of the JAX gradients,
    above 1, so the clip scales."""
    for head in ("tied", "untied"):
        want = float(optax.global_norm(runs["jax_grads"][head]))
        assert want > 1.0
        for out in runs["grad"]:
            np.testing.assert_allclose(out[head]["norm"], want, rtol=REL)


def test_scaling_stats_averaged_over_data(runs):
    """Equal shares: the JAX `compute_scaling_stats(axis_name="data")` under
    `shard_map`; unequal shares: each share's JAX statistics averaged in
    numpy (not the statistics of the pooled frames).  `init_scaling_stats`
    on the real shares: the JAX statistics of each rank's encoded clips,
    averaged."""
    from jax import shard_map
    lat, mask, shares = _stats_inputs()
    mesh = JM.make_mesh(data=2, model=1)
    fn = shard_map(lambda x, m: tuple(s[None] for s in JV.compute_scaling_stats(x, m, "data")),
                   mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")))
    want_equal = [float(np.asarray(s)[0]) for s in fn(jnp.asarray(lat), jnp.asarray(mask))]
    per = [JV.compute_scaling_stats(jnp.asarray(x), jnp.asarray(m)) for x, m in shares["unequal"]]
    want_unequal = [float(np.mean([float(p[k]) for p in per])) for k in (0, 1)]
    pooled = JV.compute_scaling_stats(jnp.asarray(lat), jnp.asarray(mask))
    assert abs(float(pooled[0]) - want_unequal[0]) > 1e-3
    jcfg, jp = _jax_params(False)
    batch = runs["batch"]
    owners = TD.clip_owners(batch)
    enc = [JV.compute_scaling_stats(
        JV.encode_voice_prompts(jp, jcfg, jax.random.PRNGKey(0),
                                jnp.asarray(batch.speech_tensors[owners // 2 == d])),
        jnp.asarray(batch.speech_masks[owners // 2 == d])) for d in (0, 1)]
    want_init = [float(np.mean([float(e[k]) for e in enc])) for k in (0, 1)]
    for out in runs["step"]:
        np.testing.assert_allclose(out["equal"], want_equal, rtol=1e-6)
        np.testing.assert_allclose(out["unequal"], want_unequal, rtol=1e-6)
        np.testing.assert_allclose(out["init_stats"], want_init, rtol=1e-5)


def test_shard_batch_and_injected_rows_follow_the_packed_order():
    """Each data rank's clips are the clips its rows own, its speech
    positions are their valid frames, T, F and the audio length stay the
    global batch's; `injected_rows` picks, for each of a rank's packed frames
    (valid first, then masked-out), the global packed rows of that frame."""
    batch = _batch()
    n_clips, f = batch.speech_masks.shape
    flat = batch.speech_masks.reshape(-1)
    order = np.argsort(~flat, kind="stable")  # global packed position -> flat frame
    pos = np.empty_like(order)
    pos[order] = np.arange(order.size)
    seen = []
    counts = []
    shares = []
    for d in (0, 1):
        share = TD.shard_batch(batch, Mesh(2, 1, rank=d, groups={}))
        assert share.input_ids.shape == (2, batch.input_ids.shape[1])
        assert share.speech_masks.shape[1] == f
        assert share.speech_tensors.shape[1] == batch.speech_tensors.shape[1]
        np.testing.assert_array_equal(share.acoustic_input_mask.sum(1),
                                      share.acoustic_loss_mask.sum(1))
        assert share.acoustic_input_mask.sum() == share.speech_masks.sum()
        clips = np.flatnonzero(TD.clip_owners(batch) // 2 == d)
        np.testing.assert_array_equal(share.speech_tensors, batch.speech_tensors[clips])
        seen.extend(clips)
        shares.append(clips)
        counts.append((share.speech_masks.sum(), share.speech_masks.size
                       - share.speech_masks.sum()))
    assert seen == list(range(n_clips))
    valid, invalid = np.array(counts).T
    covered = []
    for d, clips in enumerate(shares):
        frames = (clips[:, None] * f + np.arange(f)).reshape(-1)
        local = frames[np.argsort(~flat[frames], kind="stable")]
        want = (pos[local][:, None] * MUL + np.arange(MUL)).reshape(-1)
        got = TT.injected_rows(valid, invalid, d, MUL)
        np.testing.assert_array_equal(got, want)
        covered.extend(got)
    assert sorted(covered) == list(range(flat.size * MUL))
    with pytest.raises(ValueError, match="do not split"):
        TD.shard_batch(batch, Mesh(3, 1, rank=0, groups={}))


def test_train_shapes_that_do_not_split_are_refused():
    """`check_shard_shapes(train=True)` (the sharded step's check): a model
    axis that does not divide the KV heads, and an untied `lm_head` that is
    not this rank's column shard, raise ValueError."""
    from vibevoice_tpu_torch.parallel import check_shard_shapes, shard_params
    from vibevoice_tpu_torch.weights import from_jax
    from tests._torch_ranks import train_cfg
    cfg = train_cfg(untied=True)
    params = from_jax(to_np(_jax_params(True)[1]), device="cpu")
    local = shard_params(params, Mesh(1, 2, rank=0, groups={}), cfg=cfg)
    check_shard_shapes(local, cfg, 2, train=True)
    with pytest.raises(ValueError, match="num_key_value_heads"):
        check_shard_shapes(local, cfg, 4, train=True)
    with pytest.raises(ValueError, match="lm_head"):
        check_shard_shapes(dict(local, lm_head=params["lm_head"]), cfg, 2, train=True)


def test_host_selection_of_injected_rows_equals_the_device_one():
    """On the unequal shares of `_batch` (three clips and four), each data
    rank's rows of the global injected noise and timesteps as the step now
    takes them, on the host before the copy in (`train.select_injected`
    with the counts of `TrainStep._exchange`), equal the rows the step took
    before, gathered on the device and indexed there
    (`mesh.all_gather(counts)` then `injected_rows` as an index tensor), and
    together hold every row once."""
    import torch
    batch = _batch()
    noise, t = _noise(batch, 20)
    shares = [TD.shard_batch(batch, Mesh(2, 1, rank=d, groups={})) for d in (0, 1)]
    table = np.array([[s.speech_masks.sum(), s.speech_masks.size - s.speech_masks.sum(), 0]
                      for s in shares])
    assert table[0, 0] != table[1, 0] and table[0, 1] != table[1, 1]
    counts = torch.cat([torch.tensor([[int(s.speech_masks.sum()),
                                       int(s.speech_masks.size - s.speech_masks.sum())]])
                        for s in shares])  # the device-side gather's result
    seen = 0
    for d, share in enumerate(shares):
        got = TT.select_injected(noise, t, table[:, 0], table[:, 1], d, MUL)
        rows = torch.from_numpy(TT.injected_rows(counts[:, 0].numpy(), counts[:, 1].numpy(),
                                                 d, MUL))
        want = (torch.as_tensor(noise)[rows], torch.as_tensor(t)[rows])
        assert got[0].shape == (share.speech_masks.size * MUL, noise.shape[1])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        seen += len(got[0])
    assert seen == len(noise)
