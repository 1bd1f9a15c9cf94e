"""The captured train step's rules on the CPU (`train.TrainStep`): what a
capture records reads nothing from the host and copies nothing to the
device, unsharded and on a data=2 x model=2 mesh of gloo ranks; the CPU step
is always eager; a mesh needs `eager=True` unless its groups are NCCL; the
optimizer's split step (`set_lr` + `update`) is its whole step; the planned
gradient sum over `data` equals the flag-exchanging one; and every rank
takes the same capture decision.  The capture itself runs on the card
(`tests/test_torch_cuda.py`)."""
import copy

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch import train as T
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.parallel.mesh import Mesh

from tests._torch_ranks import (PLAN_LEAVES, Ranks, host_reads_refused, plan_grads_of,
                                train_graph_program)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One spawn of four gloo ranks, data=2 x model=2
    (`_torch_ranks.train_graph_program`)."""
    work = tmp_path_factory.mktemp("train_graph")
    return Ranks(train_graph_program, 4, work, str(work), timeout=240).results()



def _batch(cfg):
    """Two examples, three clips of 3, 1 and 2 frames (the short ones leave
    frames masked out), random semantic features."""
    from vibevoice_tpu_torch import data as D
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    rng = np.random.default_rng(0)
    hop = cfg.speech_compress_ratio
    examples = [([(1, " Hello there."), (2, " Hi.")],
                 [rng.normal(0, 0.1, 3 * hop - 8), rng.normal(0, 0.1, hop)]),
                ([(1, " Short.")], [rng.normal(0, 0.1, 2 * hop - 4)])]
    sem = lambda s: rng.normal(0, 0.1, (len(s), s.shape[1] // hop,
                                        cfg.semantic_vae_dim)).astype(np.float32)
    return D.build_training_batch(ByteFallbackTokenizer(), examples, hop=hop, semantic_fn=sem,
                                  semantic_dim=cfg.semantic_vae_dim, pad_to_multiple=64)


def _tiny():
    cfg = tiny_config(vocab_size=320)
    params = V.init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)
    return cfg, params


def _inputs(batch, cfg, injected):
    inputs = [t for t in T._host_batch(batch)]
    if injected:
        n = batch.speech_masks.size * cfg.diffusion_head.ddpm_batch_mul
        rng = np.random.default_rng(0)
        inputs += [torch.from_numpy(rng.normal(size=(n, cfg.acoustic_vae_dim))
                                    .astype(np.float32)),
                   torch.from_numpy(rng.integers(0, cfg.diffusion_head.ddpm_num_steps, n).astype(np.int32))]
    return inputs


@pytest.mark.parametrize("mesh, injected", [
    pytest.param(False, False, id="False"), pytest.param(False, True, id="True"),
    pytest.param(True, False, id="mesh-drawn"), pytest.param(True, True, id="mesh-injected")])
def test_captured_body_reads_nothing_from_the_host(monkeypatch, request, mesh, injected):
    """`TrainStep._body` (forward, backward, clip, AdamW: what the card
    captures) on static inputs: no tensor is read on the host and no array
    becomes a tensor (on the card, a host-to-device copy), with drawn and
    with injected noise (`_torch_ranks.host_reads_refused`).  AdamW itself
    is left out: on the CPU it is the non-capturable form, which reads its
    step counts; the card's capturable form is captured in
    `tests/test_torch_cuda.py`.  The mesh cases run on four gloo ranks
    (data=2 x model=2, `_prepare` and a planning warm-up first): the body
    with the model axis's collectives, the planned gradient sum over `data`,
    the clip's split path with its all-reduce over `model` and the metrics'
    sum over `data`; every rank's metrics are the data group's sums, equal
    on all four ranks."""
    if mesh:
        runs = request.getfixturevalue("mesh_runs")
        got = [r["body"][injected] for r in runs]
        for g in got:
            assert g["fresh"] and g["planned"] > 0
            assert g["inputs"] == len(T.TrainBatch._fields) + (2 if injected else 0)
            assert np.isfinite(g["metrics"]).all() and g["metrics"].shape == (3,)
            np.testing.assert_array_equal(g["metrics"], got[0]["metrics"])
        return
    cfg, params = _tiny()
    batch = _batch(cfg)
    opt = T.make_optimizer(params, lr=1e-3, warmup_steps=1, total_steps=10)
    step = T.make_train_step(cfg, opt, device="cpu")
    inputs = _inputs(batch, cfg, injected)
    gen = torch.Generator().manual_seed(1)
    opt.set_lr()
    opt.zero_grad()
    step._body(params, inputs, gen)  # the warm-up, as on the card
    monkeypatch.setattr(opt.adamw, "step", lambda: None)
    opt.zero_grad()
    with host_reads_refused():
        metrics = step._body(params, inputs, gen)
    assert metrics.shape == (3,) and bool(torch.isfinite(metrics).all())


def test_cpu_step_is_eager_and_a_mesh_needs_eager(monkeypatch):
    """On the CPU `make_train_step` never captures, whatever `eager` says.  A
    mesh needs `eager=True` unless its groups are NCCL: one without a group
    for its model axis of 2 raises on any device, as does one whose groups
    are gloo (read through `Mesh.backend`); one whose groups are all NCCL
    is accepted (on the CPU it still runs eagerly)."""
    cfg, params = _tiny()
    opt = T.make_optimizer(params)
    assert not T.make_train_step(cfg, opt, device="cpu").use_graph
    assert not T.make_train_step(cfg, opt, device="cpu", eager=True).use_graph
    mesh = Mesh(1, 2, rank=0, groups={})
    with pytest.raises(ValueError, match="eager=True"):
        T.make_train_step(cfg, opt, device="cpu", mesh=mesh)
    assert not T.make_train_step(cfg, opt, device="cpu", mesh=mesh, eager=True).use_graph
    grouped = Mesh(2, 2, rank=0, groups={"data": object(), "model": object()})
    for backend in ("gloo", "nccl"):
        monkeypatch.setattr(Mesh, "backend", lambda self, axis, b=backend: b)
        if backend == "gloo":
            with pytest.raises(ValueError, match="eager=True"):
                T.make_train_step(cfg, opt, device="cpu", mesh=grouped)
        else:
            assert not T.make_train_step(cfg, opt, device="cpu", mesh=grouped).use_graph


def test_split_optimizer_step_is_the_whole_step():
    """`set_lr`, `update` and the count's increment (what a captured step
    does around and inside its graph) give the same weights, bit for bit,
    as `step`; on the CPU the learning rate stays a host float."""
    cfg, params = _tiny()
    rng = np.random.default_rng(3)
    runs = []
    for split in (False, True):
        p = copy.deepcopy(params)
        opt = T.make_optimizer(p, lr=1e-2, warmup_steps=1, total_steps=10)
        for _ in range(3):
            for leaf in opt.leaves:
                leaf.grad = torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32)
                                             ) if leaf.dim() > 1 else None
            if split:
                lr = opt.set_lr()
                opt.update()
                opt.count += 1
                assert all(g["lr"] == lr and isinstance(g["lr"], float)
                           for g in opt.adamw.param_groups)
            else:
                opt.step()
        runs.append([x.detach().clone() for x in opt.leaves])
        rng = np.random.default_rng(3)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_planned_grad_sum_equals_the_flag_exchanging_one(mesh_runs):
    """Over the data group of two ranks, two steps of `sync_grads` on
    hand-set gradients (`_torch_ranks.PLAN_LEAVES`: a leaf both ranks touch,
    one only rank 0 touches at step 0 and no rank at step 1, one no rank
    ever touches, a bf16 leaf in a bucket of its own dtype): planned once at
    step 0, the sums are bit-equal to a plan made from each step's flags
    and to the ranks' gradients added in numpy (zeros for a rank without
    one); the leaf no rank touched stays out of the plan."""
    names = sorted(PLAN_LEAVES)
    for out in mesh_runs:
        (planned, live), (exchanged, _) = out["planned"], out["exchanged"]
        assert live == tuple(n != "d" for n in names)
        for step in range(2):
            ranks = [plan_grads_of(i, step) for i in range(2)]
            for n in names:
                parts = [r[n] for r in ranks if r[n] is not None]
                want = (sum(p.float() for p in parts).to(parts[0].dtype).float().numpy()
                        if parts else np.zeros(PLAN_LEAVES[n][0], np.float32))
                np.testing.assert_array_equal(planned[step][n], exchanged[step][n],
                                              err_msg=f"{n} step {step}")
                np.testing.assert_array_equal(planned[step][n], want,
                                              err_msg=f"{n} step {step}")


def test_capture_decision_is_the_same_on_every_rank():
    """`train.must_capture` on the gathered flags: when only data rank 0
    meets a new batch shape (its own flag set, rank 1's not), both ranks see
    the same gathered flags and both decide to warm up and capture; when
    neither does, both replay.  Each rank's own flag alone would split
    them."""
    new_on_rank0 = np.array([[7, 2, 1], [9, 3, 0]])  # valid, masked-out frames, fresh
    views = [new_on_rank0.copy() for _ in range(2)]  # what each rank's gather returns
    assert [T.must_capture(v[:, 2]) for v in views] == [True, True]
    assert [T.must_capture(new_on_rank0[r:r + 1, 2]) for r in range(2)] == [True, False]
    replay = np.array([[7, 2, 0], [9, 3, 0]])
    assert [T.must_capture(v[:, 2]) for v in (replay, replay.copy())] == [False, False]


def test_a_new_shape_on_one_data_rank_makes_every_rank_plan(mesh_runs):
    """On four gloo ranks, three eager sharded steps where only data rank 0
    meets a new batch shape at the second (its share padded by eight masked
    positions): every rank plans at the first and the second call and at
    neither later, so no rank's flag exchange waits alone (the call returns
    on every rank), and the losses are finite and equal on all ranks."""
    for out in mesh_runs:
        got = out["decisions"]
        assert got["planned"] == [True, True, False]
        assert np.isfinite(got["losses"]).all()
        assert got["losses"] == mesh_runs[0]["decisions"]["losses"]
