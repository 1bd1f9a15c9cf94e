"""Rank harness for the port's parallel tests: runs one function on N ranks of
a gloo process group, each in a process of its own (`spawn`), and collects
what each returns.

Ranks import torch, numpy and the port only, never JAX: a test makes its JAX
reference in its own process, hands weights and inputs to the ranks as `.npz`
files (`save_tree`; the ranks read them back with `load_tree` and
`weights.from_jax`), and reads the ranks' results (pickled numpy trees) from
its `tmp_path`.  Every rank runs with one thread (the suite runs under
xdist), and every spawn is joined with a deadline: a rank still alive then is
killed and the test fails, so a collective that one rank never joins costs
one test, not the suite.

The rank programs (`tp_program`, `dp_program`, `dp_stages_program`,
`cp_ring_program`, `multihost_program`, `train_grad_program`,
`train_step_program`, `train_graph_program`) live here, beside the harness,
so that a rank imports nothing of the test modules (which import JAX).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# numpy trees as .npz
# ---------------------------------------------------------------------------

_SEP = "/"


def save_tree(path, tree) -> None:
    """A tree of dicts, lists, None and arrays (bf16 included, as its bits)
    as one .npz: the leaves under their paths, the shape of the tree beside."""
    arrays: Dict[str, np.ndarray] = {}

    def walk(x, p):
        if isinstance(x, dict):
            return {"d": {k: walk(v, p + _SEP + str(k)) for k, v in x.items()}}
        if isinstance(x, (list, tuple)):
            return {"l": [walk(v, f"{p}{_SEP}{i}") for i, v in enumerate(x)]}
        if x is None:
            return None
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            arrays[p] = np.ascontiguousarray(a).view(np.uint16)
            return {"bf16": p}
        arrays[p] = a
        return {"a": p}

    skeleton = walk(tree, "")
    arrays["__tree__"] = np.frombuffer(pickle.dumps(skeleton), dtype=np.uint8)
    np.savez(path, **arrays)


def load_tree(path):
    """The tree of `save_tree`, its leaves as numpy arrays; bf16 leaves come
    back as torch bf16 tensors (numpy has no bf16)."""
    import torch

    data = np.load(path)
    skeleton = pickle.loads(data["__tree__"].tobytes())

    def build(node):
        if node is None:
            return None
        if "d" in node:
            return {k: build(v) for k, v in node["d"].items()}
        if "l" in node:
            return [build(v) for v in node["l"]]
        if "bf16" in node:
            a = data[node["bf16"]]
            return torch.from_numpy(a.astype(np.int16)).view(torch.bfloat16).reshape(a.shape)
        return data[node["a"]]

    return build(skeleton)


def to_torch(tree):
    """`load_tree`'s tree as torch tensors on the CPU (`weights.from_jax`, which
    the bf16 leaves, already tensors, skip)."""
    import torch
    from vibevoice_tpu_torch.weights import from_jax

    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if torch.is_tensor(tree):
        return tree
    return from_jax(tree, device="cpu")


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def _entry(fn: Callable, rank: int, world: int, store: str, out_dir: str, args: tuple):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store, world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """`fn(rank, world, *args)` started on `world` gloo ranks (the caller may
    work meanwhile); `results()` waits for them."""

    def __init__(self, fn: Callable, world: int, tmp_path, *args, timeout: float = 120.0):
        self.world, self.timeout = world, timeout
        self.out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
        os.makedirs(self.out_dir, exist_ok=True)
        store = os.path.join(self.out_dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, store, self.out_dir, args))
                      for r in range(world)]
        self.deadline = time.monotonic() + timeout
        for p in self.procs:
            p.start()

    def results(self) -> List[Any]:
        """What each rank returned.  AssertionError (with each failed rank's
        traceback) when a rank fails, returns nothing or is still alive
        `timeout` seconds after the start; every process is gone when this
        returns."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif r in hung:
                errors.append(f"rank {r}: still alive after {self.timeout} s, killed")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise AssertionError("\n".join(errors))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


class CollectiveCounter:
    """Counts the `torch.distributed` collectives made while it is active
    (the port calls them through the module, so wrapping the module's
    functions sees every call): per kind, calls and the bytes of the tensor
    each call sends."""

    KINDS = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all_single",
             "all_to_all", "broadcast", "reduce_scatter", "reduce_scatter_tensor", "send",
             "recv", "isend", "irecv")

    def __init__(self):
        self.calls: Dict[str, List[int]] = {}
        self._orig: Dict[str, Callable] = {}

    def __enter__(self):
        import torch.distributed as dist

        def wrap(kind, fn):
            def counted(*a, **kw):
                t = a[1] if kind in ("all_gather", "all_to_all_single", "all_gather_into_tensor",
                                     "reduce_scatter_tensor") else a[0]
                n = sum(x.numel() * x.element_size() for x in t) if isinstance(t, list) \
                    else t.numel() * t.element_size()
                self.calls.setdefault(kind, []).append(int(n))
                return fn(*a, **kw)
            return counted

        for k in self.KINDS:
            if hasattr(dist, k):
                self._orig[k] = getattr(dist, k)
                setattr(dist, k, wrap(k, self._orig[k]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self._orig.items():
            setattr(dist, k, fn)

    def summary(self) -> Dict[str, List[int]]:
        return {k: list(v) for k, v in self.calls.items()}


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

GEN = dict(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260, eos_id=256,
           cfg_scale=1.5, ddpm_steps=3, max_length_times=16.0)


def _state_np(state, extra=None) -> Dict[str, np.ndarray]:
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in ("tokens", "audio", "emitted", "frames", "finished", "reach_max")}
    if state.cache.k_scale is not None:
        out["k_scale"] = state.cache.k_scale.float().cpu().numpy()
        out["v_scale"] = state.cache.v_scale.float().cpu().numpy()
    out.update(extra or {})
    return out


def _engine_run(eng, inputs, steps, counter_steps=1):
    """prefill, one counted step, the rest: the state and the step's counts."""
    ids, mask, sim, fmask, vl, noise = inputs
    state, _ = eng.prefill(ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                           latent_noise=noise)
    with CollectiveCounter() as c:
        state, _ = eng.decode_chunk(state, counter_steps)
    state, _ = eng.decode_chunk(state, steps - 1 - counter_steps)
    return state, c.summary()


def tp_program(rank, world, work_dir, cases, steps):
    """TP=2 engines over gloo, one per case (name, weights npz, Engine
    keyword arguments); beside each, the unsharded engine on rank 0.  Also
    the refusals that need a live group, the whole-column logits subset of
    a column-split head, and the int8 KV case with the amax reduction
    removed."""
    import torch
    from vibevoice_tpu_torch import configs as TC
    from vibevoice_tpu_torch.engine import generate as TG
    from vibevoice_tpu_torch.models import vibevoice as TV
    from vibevoice_tpu_torch.parallel import make_mesh, shard_params

    cfg = TC.tiny_config(vocab_size=320)
    gen = TG.GenerationConfig(**GEN)
    inputs = load_tree(os.path.join(work_dir, "inputs.npz"))
    mesh = make_mesh(data=1, model=2)
    b, t = inputs[0].shape
    base = dict(max_steps=steps, batch=b, prompt_len=t, inject_latent_noise=True, device="cpu")
    out: Dict[str, Any] = {}
    for name, weights, kw in cases:
        params = to_torch(load_tree(os.path.join(work_dir, weights)))
        local = shard_params(params, mesh, cfg=cfg)
        eng = TG.Engine(local, cfg, gen, **base, **kw, mesh=mesh, eager=True)
        state, counts = _engine_run(eng, inputs, steps)
        out[name] = _state_np(state)
        out[name]["counts"] = counts
        out[name]["cache_lanes"] = int(state.cache.k.shape[-1])
        if rank == 0:
            ref = TG.Engine(params, cfg, gen, **base, **kw)
            out[name]["unsharded"] = _state_np(_engine_run(ref, inputs, steps)[0])
        if kw.get("kv_dtype") == "int8":
            # the same engine without the amax reduction: each rank's scales
            # cover its own lanes only
            orig = mesh.all_reduce
            mesh.all_reduce = lambda x, axis="model", op="sum": (
                x if op == "max" else orig(x, axis, op))
            try:
                eng2 = TG.Engine(local, cfg, gen, **base, **kw, mesh=mesh, eager=True)
                out[name]["no_amax_reduce"] = _state_np(_engine_run(eng2, inputs, steps)[0])
            finally:
                mesh.all_reduce = orig
        if name == "int8":
            # the int8 tree's lm_head (embed^T, int8) is split by column: the
            # engine's subset must be whole on every rank
            allowed = sorted({gen.speech_start_id, gen.speech_end_id, gen.speech_diffusion_id,
                              gen.eos_id})
            p_nosub = {k: v for k, v in local.items() if k != "_lm_head_sub"}
            sub = TV.lm_head_subset(p_nosub, allowed, torch.float32, mesh=mesh)
            want = TV.lm_head_subset(params, allowed, torch.float32)
            out["head_subset"] = {
                "split_width": int(local["lm_head"]["qint8"].shape[1]),
                "equal": all(torch.equal(sub[k], want[k]) for k in want)}
    # the refusals that need the live group: gloo cannot take a captured TP
    # step, and unsharded params do not fit a TP mesh
    params = to_torch(load_tree(os.path.join(work_dir, cases[0][1])))
    refusals = {}
    for what, p, kw in (("gloo_graph", shard_params(params, mesh, cfg=cfg), dict(eager=False)),
                        ("unsharded_params", params, dict(eager=True))):
        try:
            TG.Engine(p, cfg, gen, **base, mesh=mesh, **kw)
            refusals[what] = None
        except Exception as e:  # the type and message are the result
            refusals[what] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    return out


def dp_program(rank, world, work_dir, steps, kw):
    """A DP=2 engine over gloo on the global batch: its gathered rows, the
    collectives of a step, `generate`'s global result with a streamer
    attached, `generate` stopped by one rank's stop check, and the refusal of
    a batch that does not split."""
    from vibevoice_tpu_torch import configs as TC
    from vibevoice_tpu_torch.engine import generate as TG
    from vibevoice_tpu_torch.engine.streamer import AudioStreamer
    from vibevoice_tpu_torch.parallel import make_mesh

    cfg = TC.tiny_config(vocab_size=320)
    gen = TG.GenerationConfig(**GEN)
    inputs = load_tree(os.path.join(work_dir, "dp_inputs.npz"))
    params = to_torch(load_tree(os.path.join(work_dir, "weights.npz")))
    mesh = make_mesh(data=2, model=1)
    b, t = inputs[0].shape
    base = dict(max_steps=steps, batch=b, prompt_len=t, inject_latent_noise=True, device="cpu")
    eng = TG.Engine(params, cfg, gen, **base, **kw, mesh=mesh)
    state, counts = _engine_run(eng, inputs, steps)
    rows = eng.gather(state)
    out = {"local_batch": eng.batch, "counts": counts,
           "gathered": {k: getattr(rows, k).cpu().numpy() for k in rows._fields}}
    ids, mask, sim, fmask, vl, noise = inputs
    # the streamer gets this rank's rows under their global indices
    streamer = AudioStreamer(batch_size=b)
    res = TG.generate(eng, ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                      latent_noise=noise, audio_streamer=streamer)
    streamed = {}
    for idx, chunk in streamer:
        streamed.setdefault(idx, []).append(chunk)
    out["generate"] = {"tokens": res.tokens, "audio": res.audio, "steps": res.steps,
                       "streamed": {i: np.concatenate(c) for i, c in streamed.items()}}
    # rank 0's stop check fires before its second chunk, rank 1's never: both
    # ranks end on the same chunk
    checks = []

    def stop():
        checks.append(1)
        return rank == 0 and len(checks) >= 2

    res = TG.generate(eng, ids, mask, sim, speech_frame_masks=fmask, voice_latents=vl,
                      latent_noise=noise, stop_check_fn=stop, stream_chunk=1)
    out["stopped"] = {"tokens": res.tokens, "steps": res.steps}
    try:
        TG.Engine(params, cfg, gen, **dict(base, batch=3), mesh=mesh)
        out["odd_batch"] = None
    except Exception as e:
        out["odd_batch"] = (type(e).__name__, str(e))
    return out


def stage_packs_summary(params) -> Dict[str, Dict[int, tuple]]:
    """Per large-T stage pack: (transition conv folded, row-lane row group;
    1 without a row-lane pack).  Takes the port's packs and the JAX
    package's (both hold "vecs" [blocks, 8, D] and "rowlane" ["vecs"] [..,
    R*D])."""
    out = {}
    for key in ("_vocoder_packs_large", "_semantic_packs_large"):
        out[key] = {int(i): ("conv" in p, int(p["rowlane"]["vecs"].shape[2]
                                              // p["vecs"].shape[2]) if "rowlane" in p else 1)
                    for i, p in params[key].items()}
    return out


def dp_stages_program(rank, world, work_dir, steps, batches):
    """A DP=2 engine with the fused large-T stages (`fused_stage_t_min=7`, the
    tiny model's stages) at each global batch of `batches`, on the first rows
    of the DP inputs: its gathered rows and its stage packs' summary."""
    from vibevoice_tpu_torch import configs as TC
    from vibevoice_tpu_torch.engine import generate as TG
    from vibevoice_tpu_torch.parallel import make_mesh

    cfg = TC.tiny_config(vocab_size=320)
    gen = TG.GenerationConfig(**GEN)
    inputs = load_tree(os.path.join(work_dir, "dp_inputs.npz"))
    params = to_torch(load_tree(os.path.join(work_dir, "weights.npz")))
    mesh = make_mesh(data=2, model=1)
    out = {}
    for b in batches:
        rows = [a[:b] for a in inputs[:5]] + [inputs[5][:, :b]]
        eng = TG.Engine(params, cfg, gen, max_steps=steps, batch=b, prompt_len=rows[0].shape[1],
                        inject_latent_noise=True, device="cpu", mesh=mesh,
                        use_fused_stages=True, fused_stage_t_min=7)
        state, _ = _engine_run(eng, rows, steps)
        got = eng.gather(state)
        out[b] = {"local_batch": eng.batch, "packs": stage_packs_summary(eng.params),
                  "gathered": {k: getattr(got, k).cpu().numpy() for k in got._fields}}
    return out


def train_cfg(untied: bool = False):
    """The port's config of the sharded training tests: `tiny_config(vocab_size
    =320)` with the acoustic VAE at `fix_std = 0` (deterministic latents), its
    `lm_head` untied on request."""
    import dataclasses
    from vibevoice_tpu_torch import configs as TC

    c = TC.tiny_config(vocab_size=320)
    c = dataclasses.replace(c, acoustic_tokenizer=dataclasses.replace(c.acoustic_tokenizer,
                                                                      fix_std=0.0))
    if untied:
        c = dataclasses.replace(c, decoder=dataclasses.replace(c.decoder,
                                                               tie_word_embeddings=False))
    return c


def _train_batch(work_dir):
    from vibevoice_tpu_torch.train import TrainBatch
    return TrainBatch(*load_tree(os.path.join(work_dir, "batch.npz")))


def _split_dims(params, cfg):
    from vibevoice_tpu_torch.parallel import model_param_specs, split_dims
    return split_dims(params, model_param_specs(params, cfg), "model")


def train_grad_program(rank, world, work_dir, mul):
    """One backward of the training loss on a model=2 mesh, tied and untied
    `lm_head`: each trainable leaf's gradient on this rank (None where autograd
    left none), the dimension each leaf is split along, and the optimizer's
    global norm before its clip."""
    import torch
    from vibevoice_tpu_torch import train as TT
    from vibevoice_tpu_torch.models import vibevoice as TV
    from vibevoice_tpu_torch.parallel import make_mesh, model_param_specs, shard_params

    mesh = make_mesh(data=1, model=world)
    noise, t = load_tree(os.path.join(work_dir, "noise0.npz"))
    b = TT._device_batch(_train_batch(work_dir), "cpu")
    out = {}
    for name, untied in (("tied", False), ("untied", True)):
        cfg = train_cfg(untied)
        params = to_torch(load_tree(os.path.join(work_dir, f"weights_{name}.npz")))
        dims = _split_dims(params, cfg)
        local = shard_params(params, mesh, cfg=cfg)
        opt = TT.make_optimizer(local, mesh=mesh, specs=model_param_specs(params, cfg))
        res = TV.training_forward(
            local, cfg, TT.solver_tables(cfg), None, input_ids=b.input_ids,
            attention_mask=b.attention_mask, speech_tensors=b.speech_tensors,
            speech_masks=b.speech_masks, speech_semantic_tensors=b.speech_semantic_tensors,
            acoustic_input_mask=b.acoustic_input_mask, acoustic_loss_mask=b.acoustic_loss_mask,
            labels=b.labels, ddpm_batch_mul=mul, injected_noise=torch.from_numpy(noise),
            injected_timesteps=torch.from_numpy(t), mesh=mesh)
        (res.ce_loss + res.diffusion_loss).backward()
        grads = [None if p.grad is None else p.grad.numpy().copy() for p in opt.leaves]
        for p in opt.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = float(opt.clip_())
        out[name] = {"grads": grads, "dims": dims, "norm": norm,
                     "logits": res.logits.detach().numpy(),
                     "losses": (float(res.ce_loss), float(res.diffusion_loss))}
    return out


def train_step_program(rank, world, work_dir, data, model, mul, steps):
    """`make_train_step` on a data x model mesh over the global batch's
    `data.shard_batch` share: each step's metrics, every leaf after the steps
    (with its split dimension), the q shard's width, this rank's clips, the
    scaling statistics (`init_scaling_stats` on the share, and
    `compute_scaling_stats` of the given latents: equal and unequal
    shares), each averaged over the data group."""
    import torch
    from vibevoice_tpu_torch import data as TD, train as TT
    from vibevoice_tpu_torch.models import vibevoice as TV
    from vibevoice_tpu_torch.parallel import make_mesh, model_param_specs, shard_params

    cfg = train_cfg()
    mesh = make_mesh(data=data, model=model)
    di = mesh.axis_index("data")
    params = to_torch(load_tree(os.path.join(work_dir, "weights_tied.npz")))
    dims = _split_dims(params, cfg)
    batch = _train_batch(work_dir)
    mine = TD.shard_batch(batch, mesh)
    local = shard_params(params, mesh, cfg=cfg)
    out = {"clips": np.flatnonzero((TD.clip_owners(batch) // (batch.input_ids.shape[0] // data))
                                   == di),
           "dims": dims, "rows": mine.input_ids.shape[0]}
    stats = TT.init_scaling_stats(local, cfg, None, mine, device="cpu", mesh=mesh)
    out["init_stats"] = (float(stats["speech_scaling_factor"]),
                         float(stats["speech_bias_factor"]))
    lat = load_tree(os.path.join(work_dir, "stats.npz"))
    for case in ("equal", "unequal"):
        x, m = lat[case][di]
        out[case] = tuple(float(v) for v in TV.compute_scaling_stats(
            torch.from_numpy(x), torch.from_numpy(m), mesh=mesh))
    opt = TT.make_optimizer(local, lr=1e-2, warmup_steps=1, total_steps=10, mesh=mesh,
                            specs=model_param_specs(params, cfg))
    step = TT.make_train_step(cfg, opt, ddpm_batch_mul=mul, device="cpu", mesh=mesh,
                              eager=True)
    out["metrics"] = []
    for i in range(steps):
        noise, t = load_tree(os.path.join(work_dir, f"noise{i}.npz"))
        m = step(local, mine, None, noise, t)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["leaves"] = [p.detach().numpy().copy() for p in opt.leaves]
    out["q_width"] = int(local["lm"]["layers"][0]["q"]["w"].shape[1])
    return out


class host_reads_refused:
    """While entered, a tensor read on the host (`bool`, `int`, `float`,
    `item`, `tolist`, `numpy`, an index by a boolean tensor, whose shape the
    host must read) and a tensor made from host data (`torch.tensor`,
    `torch.from_numpy`, `torch.as_tensor` of anything but a tensor) raise
    AssertionError: on the card each is a copy between the host and the
    device, which a CUDA graph cannot record."""

    NAMES = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy")

    def __enter__(self):
        import torch

        def refuse(*_a, **_k):
            raise AssertionError("the captured step reads the host or copies to the device")

        def tensors_only(fn):
            def call(x, *a, **k):
                if not isinstance(x, torch.Tensor):
                    refuse()
                return fn(x, *a, **k)
            return call

        getitem = torch.Tensor.__getitem__

        def no_bool_index(x, idx):
            parts = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in parts):
                refuse()
            return getitem(x, idx)

        self.saved = ([(torch.Tensor, n, getattr(torch.Tensor, n))
                       for n in self.NAMES + ("__getitem__",)]
                      + [(torch, n, getattr(torch, n)) for n in ("as_tensor", "from_numpy",
                                                                 "tensor")])
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)
        torch.Tensor.__getitem__ = no_bool_index
        torch.as_tensor = tensors_only(torch.as_tensor)
        torch.from_numpy = torch.tensor = refuse
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def four_row_batch():
    """The port's `data.build_training_batch` of the four examples of
    `tests/test_torch_train_sharded.py` (hop 16; data rank 0 of two takes
    rows 0-1 with three clips, rank 1 rows 2-3 with four, each with
    masked-out frames)."""
    from vibevoice_tpu_torch import data as TD
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
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
    return TD.build_training_batch(ByteFallbackTokenizer(), examples, hop=16,
                                   semantic_fn=sem_fn, semantic_dim=16)


# the leaves of `grad_plan_program`: (shape, dtype, the data ranks whose
# backward gives the leaf a gradient at step 0, and at step 1)
PLAN_LEAVES = {"a": ((3, 4), "float32", (0, 1), (0, 1)), "b": ((5,), "float32", (0, 1), (1,)),
               "c": ((2, 2), "float32", (0,), ()), "d": ((3,), "float32", (), ()),
               "e": ((4,), "bfloat16", (0, 1), (0,))}


def plan_grads_of(index: int, step: int):
    """Data rank `index`'s gradients at `step` of `grad_plan_program`
    (None where PLAN_LEAVES gives it none), from a seed of both."""
    import torch
    rng = np.random.default_rng(100 * step + index)
    out = {}
    for name, (shape, dtype, *who) in sorted(PLAN_LEAVES.items()):
        g = rng.normal(size=shape).astype(np.float32)
        out[name] = (torch.from_numpy(g).to(getattr(torch, dtype)) if index in who[step]
                     else None)
    return out


def _grad_plan_run(mesh, replan_each_step: bool):
    """Two steps of `sync_grads` on PLAN_LEAVES' gradients: the planned path
    (`plan_grads` at the first step only) or the flag-exchanging one (a plan
    of each step's flags alone, made at every step).  Each step's summed
    gradients, with a leaf left without one as zeros (what `update` gives
    it)."""
    import torch
    from vibevoice_tpu_torch import train as TT

    params = {k: torch.zeros(shape, dtype=getattr(torch, dtype))
              for k, (shape, dtype, *_w) in PLAN_LEAVES.items()}
    opt = TT.make_optimizer(params, mesh=mesh)
    names = sorted(PLAN_LEAVES)
    out = []
    for step in range(2):
        grads = plan_grads_of(mesh.axis_index("data"), step)
        for name, p in zip(names, opt.leaves):
            p.grad = None if grads[name] is None else grads[name].clone()
        if replan_each_step:
            opt.plan = None
        if replan_each_step or step == 0:
            opt.plan_grads()
        opt.sync_grads()
        out.append({n: (torch.zeros_like(p) if p.grad is None else p.grad).float().numpy()
                    for n, p in zip(names, opt.leaves)})
    return out, opt.plan.live


def train_graph_program(rank, world, work_dir):
    """On a data=2 x model=2 mesh: the sharded step's body (`TrainStep._body`
    after `_prepare` and a warm-up, as the card captures it) under
    `host_reads_refused`, with drawn and with injected noise (AdamW's step
    left out: on the CPU it is the non-capturable form), and its metrics;
    and, over the data group, `sync_grads` planned once against the
    flag-exchanging path (`_grad_plan_run`); and the eager step's decisions
    when one data rank meets a new shape (`_one_rank_new_shape`)."""
    import torch
    from vibevoice_tpu_torch import data as TD, train as TT
    from vibevoice_tpu_torch.models import vibevoice as TV
    from vibevoice_tpu_torch.parallel import make_mesh, model_param_specs, shard_params
    from vibevoice_tpu_torch.parallel.mesh import Mesh

    cfg = train_cfg()
    mesh = make_mesh(data=2, model=2)
    di = mesh.axis_index("data")
    batch = four_row_batch()
    mine = TD.shard_batch(batch, mesh)
    out = {"body": {}}
    for injected in (False, True):
        params = TV.init_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        params["speech_scaling_factor"] = torch.tensor(0.8)
        params["speech_bias_factor"] = torch.tensor(0.1)
        local = shard_params(params, mesh, cfg=cfg)
        opt = TT.make_optimizer(local, lr=1e-3, warmup_steps=1, total_steps=10, mesh=mesh,
                                specs=model_param_specs(params, cfg))
        step = TT.make_train_step(cfg, opt, ddpm_batch_mul=4, device="cpu", mesh=mesh,
                                  eager=True)
        noise = [None, None]
        if injected:
            n = batch.speech_masks.size * 4
            rng = np.random.default_rng(3)
            noise = [rng.normal(size=(n, cfg.acoustic_vae_dim)).astype(np.float32),
                     rng.integers(0, cfg.diffusion_head.ddpm_num_steps, n).astype(np.int32)]
        gen = None if injected else torch.Generator().manual_seed(1 + di)
        host, key, fresh = step._prepare(local, mine, gen, *noise)
        opt.set_lr()
        opt.zero_grad()
        step._body(local, host, gen, plan=True)  # the warm-up, as on the card
        saved = opt.adamw.step
        opt.adamw.step = lambda: None
        opt.zero_grad()
        try:
            with host_reads_refused():
                metrics = step._body(local, host, gen)
        finally:
            opt.adamw.step = saved
        out["body"][injected] = {"metrics": metrics.numpy().copy(), "fresh": fresh,
                                 "inputs": len(host), "planned": sum(opt.plan.live)}
    dmesh = Mesh(2, 1, rank=di, groups={"data": mesh.group("data")})
    out["planned"] = _grad_plan_run(dmesh, False)
    out["exchanged"] = _grad_plan_run(dmesh, True)
    out["decisions"] = _one_rank_new_shape(step, local, mine, di)
    return out


def _padded(batch, extra: int):
    """`batch` with `extra` more text positions at the end (masked out,
    ignored by the loss, no speech): the same example in another shape."""
    from vibevoice_tpu_torch.train import TrainBatch
    fill = {"input_ids": 0, "attention_mask": 0, "labels": -100, "acoustic_input_mask": False,
            "acoustic_loss_mask": False}
    return TrainBatch(**{k: np.pad(v, ((0, 0), (0, extra)), constant_values=fill[k])
                         if k in fill else v for k, v in batch._asdict().items()})


def _one_rank_new_shape(step, local, mine, di):
    """Three eager steps where only data rank 0 meets a new shape at the
    second (its share padded): which calls planned (`_body`'s `plan`) and
    the losses.  Were the decision this rank's own, rank 0's data group
    would plan alone and its flag exchange would wait for a peer that never
    joins."""
    import torch
    seen = []
    body = step._body

    def record(params, inputs, generator, plan=False):
        seen.append(plan)
        return body(params, inputs, generator, plan)

    step._body = record
    losses = []
    for call in range(3):
        b = _padded(mine, 8) if (call == 1 and di == 0) else mine
        m = step(local, b, torch.Generator().manual_seed(1 + di))
        losses.append(float(m["loss"]))
    step._body = body
    return {"planned": seen, "losses": losses}


def cp_ring_program(rank, world, work_dir):
    """Context-parallel and ring prefill on `world` ranks of the data axis:
    each rank's rows of the CP (dense and flash-plain) and ring outputs, and
    the collectives each made."""
    import torch
    from vibevoice_tpu_torch.parallel import make_mesh
    from vibevoice_tpu_torch.parallel.context_parallel import cp_prefill_attention
    from vibevoice_tpu_torch.parallel.ring_attention import ring_prefill_attention

    mesh = make_mesh(data=world, model=1)
    out = {}
    for case in ("cp", "ring"):
        q, k, v, pad = (torch.from_numpy(np.asarray(a))
                        for a in load_tree(os.path.join(work_dir, f"{case}.npz")))
        n = q.shape[1] // world
        rows = slice(rank * n, (rank + 1) * n)
        args = (q[:, rows].contiguous(), k[:, rows].contiguous(), v[:, rows].contiguous(),
                pad[:, rows].to(torch.int32).contiguous(), mesh)
        with CollectiveCounter() as c:
            if case == "cp":
                out["cp_dense"] = cp_prefill_attention(*args, use_flash=False).numpy()
                out["cp_flash"] = cp_prefill_attention(*args, use_flash=True).numpy()
            else:
                out["ring"] = ring_prefill_attention(*args).numpy()
        out[case + "_counts"] = c.summary()
    return out


def multihost_program(rank, world):
    """`global_mesh`, `shard_batch_for_host` and `dp_scaling_report` on live
    ranks."""
    from vibevoice_tpu_torch.parallel import multihost as mh

    m_tp = mh.global_mesh(model_parallel=world)
    m_dp = mh.global_mesh(model_parallel=1)
    batch = {"x": np.arange(8 * 5, dtype=np.float32).reshape(8, 5), "y": None}
    local = mh.shard_batch_for_host(batch, m_dp)
    rep = mh.dp_scaling_report(12.0 / (rank + 1), 3.0 + rank)
    return {"tp_shape": dict(m_tp.shape), "tp_coords": m_tp.coords,
            "dp_shape": dict(m_dp.shape), "dp_coords": m_dp.coords,
            "x": local["x"], "y": local["y"], "report": rep}


__all__ = ["save_tree", "load_tree", "to_torch", "Ranks", "CollectiveCounter",
           "tp_program", "dp_program", "dp_stages_program", "stage_packs_summary",
           "cp_ring_program", "multihost_program", "train_cfg", "train_grad_program",
           "train_step_program", "train_graph_program", "host_reads_refused",
           "four_row_batch", "plan_grads_of", "PLAN_LEAVES", "GEN"]
