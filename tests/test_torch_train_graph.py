"""The captured train step's rules on the CPU (`train.TrainStep`): what a
capture records reads nothing from the host and copies nothing to the
device, the CPU step is always eager, a mesh needs `eager=True`, and the
optimizer's split step (`set_lr` + `update`) is its whole step.  The capture
itself runs on the card (`tests/test_torch_cuda.py`)."""
import copy

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch import train as T
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.parallel.mesh import Mesh



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


@pytest.mark.parametrize("injected", [False, True])
def test_captured_body_reads_nothing_from_the_host(monkeypatch, injected):
    """`TrainStep._body` (forward, backward, clip, AdamW: what the card
    captures) on static inputs: no tensor is read on the host and no array
    becomes a tensor (on the card, a host-to-device copy), with drawn and
    with injected noise.  AdamW itself is left out: on the CPU it is the
    non-capturable form, which reads its step counts; the card's capturable
    form is captured in `tests/test_torch_cuda.py`."""
    cfg, params = _tiny()
    batch = _batch(cfg)
    opt = T.make_optimizer(params, lr=1e-3, warmup_steps=1, total_steps=10)
    step = T.make_train_step(cfg, opt, device="cpu")
    inputs = _inputs(batch, cfg, injected)
    gen = torch.Generator().manual_seed(1)
    opt.set_lr()
    opt.zero_grad()
    step._body(params, inputs, gen)  # the warm-up, as on the card

    def refuse(*_a, **_k):
        raise AssertionError("the captured step reads the host or copies to the device")

    def tensors_only(fn):
        def call(x, *a, **k):
            if not isinstance(x, torch.Tensor):
                refuse()
            return fn(x, *a, **k)
        return call

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "as_tensor", tensors_only(torch.as_tensor))
    for name in ("from_numpy", "tensor"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(opt.adamw, "step", lambda: None)
    opt.zero_grad()
    metrics = step._body(params, inputs, gen)
    monkeypatch.undo()
    assert metrics.shape == (3,) and bool(torch.isfinite(metrics).all())


def test_cpu_step_is_eager_and_a_mesh_needs_eager():
    """On the CPU `make_train_step` never captures, whatever `eager` says;
    a mesh without `eager=True` raises on any device."""
    cfg, params = _tiny()
    opt = T.make_optimizer(params)
    assert not T.make_train_step(cfg, opt, device="cpu").use_graph
    assert not T.make_train_step(cfg, opt, device="cpu", eager=True).use_graph
    mesh = Mesh(1, 2, rank=0, groups={})
    with pytest.raises(ValueError, match="eager=True"):
        T.make_train_step(cfg, opt, device="cpu", mesh=mesh)
    assert not T.make_train_step(cfg, opt, device="cpu", mesh=mesh, eager=True).use_graph


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
