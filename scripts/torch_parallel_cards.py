#!/usr/bin/env python3
"""The port's parallel paths with one rank a card, over NCCL: tensor-parallel
decode (eager and captured in a CUDA graph), data-parallel serving, and
context-parallel and ring prefill, each beside the same work on one card.

    python3 -c "from vibevoice_tpu_torch.ops import cuda_build; cuda_build.build_all()"
    python3 -m torch.distributed.run --nproc_per_node 4 scripts/torch_parallel_cards.py
    python3 -m torch.distributed.run --nproc_per_node 4 scripts/torch_parallel_cards.py train

Every rank calls `parallel.multihost.initialize()` (NCCL, the card of its
LOCAL_RANK) and `make_mesh`.  With N ranks (N >= 2):
  * TP=2 on ranks 0-1, the bf16 1.5B of `chip_smoke.py` phase 10 (B=1, a
    1024-token prompt, a 4096-slot cache), eager and then from the captured
    step, while rank 2 (rank 0 after them, with N = 2) runs the unsharded
    engine on its own card: ms/frame of each, the graph's kernel and NCCL
    nodes, tokens equal and the prompt's last hidden state beside the
    unsharded one;
  * DP=N, the served configuration (int4 + int4k + head int4k + fused
    stages) on a global batch of 2N rows, each rank its own graph, against
    the unsharded engine on the same 2N rows on rank 0's card alone:
    audio-s/s of both (`dp_scaling_report`), tokens equal;
  * CP over N ranks at T = 4096 N and ring at T = 2048 N (H=12, KVH=2,
    D=128): wall ms per call, every query row against the plain version of
    flash prefill over all rows on rank 0's card.
With `train` (N a multiple of 2, no kernel build needed) it runs the
sharded training step instead: a data=N/2 x model=2 mesh, the fp32 1.5B at
full width and depth (`parallel.shard_params`: each rank the whole σ-VAE
stacks, head, connectors and embedding, half of each LM layer), the batch of
`chip_smoke.py` phase 9 (2 rows x 1024 tokens of the demo voices) split over
`data` (`data.shard_batch`), `init_scaling_stats` averaged over `data`, and
TRAIN_STEPS `train_step`s (`make_train_step(mesh=)`, lr 1e-4 after a warm-up
step) in two turns from the same weights, batch and generator seeds: eager,
each step split into forward, backward, the gradient all-reduce over `data`
and the optimizer; then captured (the default over NCCL: a warm-up step and
the capture, then replays), each step's device ms, the capture's seconds,
the graph pool's bytes and the graph's kernel, NCCL and other nodes.  Both
turns' losses and every leaf must be bit-equal; each rank's peak memory.
One JSON line per result from rank 0, then the cards' name and power limit.
"""
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vibevoice_tpu_torch.configs import vibevoice_1_5b  # noqa: E402
from vibevoice_tpu_torch.engine import generate as G  # noqa: E402
from vibevoice_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vibevoice_tpu_torch.parallel import (  # noqa: E402
    make_mesh, model_param_specs, multihost, shard_params)
from vibevoice_tpu_torch.parallel.context_parallel import cp_prefill_attention  # noqa: E402
from vibevoice_tpu_torch.parallel.ring_attention import ring_prefill_attention  # noqa: E402


CFG = vibevoice_1_5b()
WARM, TIMED = 8, 16
CP_ROWS = 4096  # query rows a rank at CP; half that at ring


def engine(params, batch, prompt, steps, dev, **kw):
    return G.Engine(params, CFG, cs.parallel_gen(G), max_steps=steps, batch=batch,
                    prompt_len=prompt, dtype=torch.bfloat16, device=dev,
                    inject_latent_noise=True, **kw)


def summary(r):
    return {k: r[k] for k in ("ms_per_frame", "frames", "wall_s")}


def phase_tp(rank, world, dev, report):
    """TP=2 on ranks 0-1, eager then captured; the unsharded engine on rank
    2's card meanwhile (rank 0 afterwards when N = 2)."""
    mesh = make_mesh(data=1, model=2)
    inputs = cs.parallel_inputs(1, cs.PAR_PROMPT, WARM + TIMED + 1, CFG)
    out = {}
    if rank < 2:
        local = shard_params(cs.parallel_params(CFG, dev, "bf16"), mesh, cfg=CFG)
        eager = engine(local, 1, cs.PAR_PROMPT, cs.PAR_STEPS, dev, mesh=mesh, eager=True)
        r = cs.par_run(eager, inputs, WARM, TIMED, dev)
        ar = r["collectives"].get("all_reduce", {"calls": 0, "s": 0.0})
        out["eager"] = dict(summary(r), all_reduces_per_step=ar["calls"] / TIMED,
                            all_reduce_ms_per_step=1e3 * ar["s"] / TIMED,
                            all_reduce_share=ar["s"] / r["wall_s"])
        out["tokens"], out["hidden"] = r["tokens"], r["hidden"]
        del eager, r
        eng = engine(local, 1, cs.PAR_PROMPT, cs.PAR_STEPS, dev, mesh=mesh)
        g = cs.par_run(eng, inputs, WARM, TIMED, dev)
        nodes, other = cs.graph_launches(eng.graph)
        nccl = sum("nccl" in n.lower() for n in cs.graph_kernels(eng.graph))
        out["graph"] = dict(summary(g), captures=eng.captures, capture_s=eng.capture_s,
                            kernel_nodes=nodes, nccl_nodes=nccl, other_nodes=other,
                            device_ms_per_replay=cs.cuda_ms(lambda i: eng.graph.replay(), 10),
                            tokens_equal_eager=torch.equal(g["tokens"], out["tokens"]),
                            hidden_equal_eager=torch.equal(g["hidden"], out["hidden"]))
        del eng, g, local
    if rank == (2 if world > 2 else 0):
        params = cs.parallel_params(CFG, dev, "bf16")
        base = {}
        for mode, kw in (("eager", dict(eager=True)), ("graph", {})):
            r = cs.par_run(engine(params, 1, cs.PAR_PROMPT, cs.PAR_STEPS, dev, **kw), inputs,
                           WARM, TIMED, dev)
            base[mode] = summary(r)
        base["tokens"], base["hidden"] = r["tokens"], r["hidden"]
        out["unsharded"] = base
        del params
    torch.cuda.empty_cache()
    got = [None] * world
    dist.all_gather_object(got, {k: v for k, v in out.items()})
    if rank == 0:
        tp, base = got[0], got[2 if world > 2 else 0]["unsharded"]
        report("tp", ranks=[{k: v for k, v in got[r].items()
                             if k in ("eager", "graph")} for r in range(2)],
               unsharded={k: base[k] for k in ("eager", "graph")},
               tokens_equal=all(torch.equal(got[r]["tokens"], base["tokens"]) for r in range(2)),
               hidden_rel_l2=[cs.rel_l2(got[r]["hidden"], base["hidden"]) for r in range(2)],
               ranks_hidden_equal=torch.equal(got[0]["hidden"], got[1]["hidden"]),
               graph_speedup=base["graph"]["ms_per_frame"] / tp["graph"]["ms_per_frame"])


def phase_dp(rank, world, dev, report):
    """DP=N on 2N rows, each rank its own graph, beside the unsharded 2N-row
    engine on rank 0's card alone (run first, the others waiting)."""
    mesh = make_mesh(data=world, model=1)
    b = 2 * world
    inputs = cs.parallel_inputs(b, cs.DP_PROMPT, WARM + TIMED + 1, CFG)
    params = cs.parallel_params(CFG, dev, "int4")
    kw = dict(use_fused_stages=True)  # the int4 chain packs are in the params
    base = None
    if rank == 0:
        r = cs.par_run(engine(params, b, cs.DP_PROMPT, cs.DP_STEPS, dev, **kw), inputs,
                       WARM, TIMED, dev)
        audio_s = r["frames"] * CFG.speech_compress_ratio / 24000.0
        base = dict(summary(r), audio_s_per_s=audio_s / r["wall_s"], tokens=r["tokens"])
    dist.barrier()
    eng = engine(params, b, cs.DP_PROMPT, cs.DP_STEPS, dev, mesh=mesh, **kw)
    r = cs.par_run(eng, inputs, WARM, TIMED, dev)
    rows = eng.gather(r["state"])
    audio_s = r["frames"] * CFG.speech_compress_ratio / 24000.0
    rep = multihost.dp_scaling_report(audio_s, r["wall_s"])
    n = r["tokens"].shape[1]
    if rank == 0:
        report("dp", ranks=world, batch=b, rank0=summary(r), captures=eng.captures,
               collectives_in_steps=r["collectives"], dp_scaling_report=rep,
               unsharded={k: v for k, v in base.items() if k != "tokens"},
               scaling=rep["throughput"] / base["audio_s_per_s"],
               tokens_equal=torch.equal(rows.tokens[:, :n].cpu(), base["tokens"]))
    del eng, params


def phase_cp_ring(rank, world, dev, report):
    """CP at T = rows N and ring at T = rows N / 2, each rank its rows; the
    outputs gathered to rank 0 and held against one card's flash prefill."""
    mesh = make_mesh(data=world, model=1)
    for case, rows, seed in (("cp", CP_ROWS, cs.SEED + 20), ("ring", CP_ROWS // 2,
                                                             cs.SEED + 21)):
        t = rows * world
        q, k, v, mask = cs.flash_inputs(1, t, 0, torch.Generator(device=dev).manual_seed(seed),
                                        dev)
        mine = tuple(x[:, rank * rows:(rank + 1) * rows].contiguous() for x in (q, k, v, mask))
        fn = cp_prefill_attention if case == "cp" else ring_prefill_attention
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*mine, mesh)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        full = mesh.all_gather(got, "data", dim=1)
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fa.flash_attention_prefill(q, k, v, mask)
            torch.cuda.synchronize()
            one_ms = 1e3 * (time.perf_counter() - t0)
            want = fa.flash_attention_prefill_ref(q, k, v, mask)
            tol = cs.ROW_REL_TOL * (1 if case == "cp" else 2)
            err, worst, _ = cs.agree_rows(case, full.cpu(), want.cpu(),
                                          torch.ones(full.shape[:2], dtype=torch.int32), tol=tol)
            report(case, t=t, ranks=world, rows_per_rank=rows, wall_ms=ms,
                   one_card_flash_ms=one_ms, max_abs_err=err, worst_row_rel=worst, tol=tol)
        del q, k, v, mask, mine, got, full


TRAIN_STEPS = 4


def _train_turn(mesh, dev, batch, eager, gen):
    """TRAIN_STEPS steps of the sharded fp32 1.5B from the seed's weights:
    eager, each step split by CUDA events into forward, backward, the
    gradient all-reduce over `data` and the optimizer (`ShardMarks`); or
    captured, each step's device ms by CUDA events around the call, with the
    first step's capture seconds, the graph pool's bytes and the graph's
    nodes.  Returns the turn's summary, its losses and every leaf afterwards
    (on the host)."""
    import gc
    from vibevoice_tpu_torch import data as D, train as T
    from vibevoice_tpu_torch.models import vibevoice as V
    torch.cuda.reset_peak_memory_stats()
    params = V.init_model(CFG, dtype=torch.float32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    local = shard_params(params, mesh, cfg=CFG)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mine = D.shard_batch(batch, mesh)
    local = T.init_scaling_stats(local, CFG, gen(), mine, device=dev, mesh=mesh)
    opt = T.make_optimizer(local, lr=1e-4, weight_decay=0.01, warmup_steps=1, total_steps=100,
                           mesh=mesh, specs=model_param_specs(local, CFG))
    step = T.make_train_step(CFG, opt, device=dev, mesh=mesh, eager=eager)
    steps, losses = [], []
    out = {}
    for i in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        if eager:
            with cs.ShardMarks(V, opt) as marks:
                m = step(local, mine, gen())
        else:
            m = step(local, mine, gen())
        end.record()
        losses.append(torch.stack([m[k] for k in T.METRICS]).cpu())
        wall = time.perf_counter() - t0
        parts = marks.parts_ms() if eager else {"step": start.elapsed_time(end)}
        steps.append(dict(zip(T.METRICS, losses[-1].tolist()), wall_ms=1e3 * wall,
                          **parts))
        if not eager and i == 0:
            out.update(capture_s=step.capture_s, first_step_wall_s=wall,
                       pool_bytes=cs.pool_bytes(step.pool),
                       max_memory_allocated_capture=torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
    leaves = [p.detach().cpu() for p in opt.leaves]
    out.update(steps=steps, max_memory_allocated=torch.cuda.max_memory_allocated(),
               rows=int(mine.input_ids.shape[0]), clips=int(mine.speech_masks.shape[0]),
               params_on_rank=sum(p.numel() for p in opt.leaves))
    if not eager:
        (cap,) = step.graphs.values()
        out.update(captures=step.captures, replays=step.replays,
                   **cs.node_counts(cs.graph_kernels(cap.graph)),
                   # after the turn's leaves are kept: these replays train on
                   device_ms_per_replay=cs.cuda_ms(lambda i: cap.graph.replay(), 3))
    del opt, step, local, m
    gc.collect()
    torch.cuda.empty_cache()
    return out, losses, leaves


def phase_train(rank, world, dev, report):
    """The data x model training step of the full 1.5B in fp32, one rank a
    card, in two turns from the same weights, batch and generator seeds:
    eager (`make_train_step(mesh=, eager=True)`), then captured (its default
    over NCCL: the collectives of the model and data groups are nodes of the
    graph).  The turns must be bit-equal: every rank's losses at every step
    and every leaf afterwards.  The ranks of a data group draw the same noise
    (their generator's seed is the data index's), other groups other noise."""
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.models import vibevoice as V
    import numpy as np
    mesh = multihost.global_mesh(model_parallel=2)
    di = mesh.axis_index("data")
    gen = lambda: torch.Generator(device=dev).manual_seed(cs.SEED + di)
    params = V.init_model(CFG, dtype=torch.float32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(cs.SEED))
    batch = cs.speech_batch(params, CFG, dev, ROOT)
    del params
    torch.cuda.empty_cache()
    eager, e_losses, e_leaves = _train_turn(mesh, dev, batch, True, gen)
    graph, g_losses, g_leaves = _train_turn(mesh, dev, batch, False, gen)
    differ = sum(not torch.equal(a, b) for a, b in zip(e_leaves, g_leaves))
    mine_out = dict(rank=rank, coords=mesh.coords, eager=eager, graph=graph,
                    losses_equal=all(torch.equal(a, b) for a, b in zip(e_losses, g_losses)),
                    leaves=len(e_leaves), leaves_differ=differ)
    del e_leaves, g_leaves
    got = [None] * world
    dist.all_gather_object(got, mine_out)
    if rank == 0:
        finite = all(np.isfinite(s[k]) for g in got for t in ("eager", "graph")
                     for s in g[t]["steps"] for k in T.METRICS)
        same = all([s["loss"] for s in g["graph"]["steps"]]
                   == [s["loss"] for s in got[0]["graph"]["steps"]] for g in got)
        bit_equal = all(g["losses_equal"] and g["leaves_differ"] == 0 for g in got)
        later = lambda t, k: float(np.mean([s[k] for g in got for s in g[t]["steps"][1:]]))
        mean_eager = {k: later("eager", k) for k in ("forward", "backward", "allreduce",
                                                     "optimizer", "step", "wall_ms")}
        mean_graph = {k: later("graph", k) for k in ("step", "wall_ms")}
        report("train", mesh=dict(mesh.shape), model="vibevoice_1_5b", dtype="fp32",
               batch=list(batch.input_ids.shape), steps=TRAIN_STEPS, ranks=got,
               eager_mean_ms_steps_2_on=mean_eager, graph_mean_ms_steps_2_on=mean_graph,
               eager_over_graph=mean_eager["step"] / mean_graph["step"],
               capture_s=[g["graph"]["capture_s"] for g in got],
               pool_gb=[g["graph"]["pool_bytes"] / 1e9 for g in got],
               peak_gb=[max(g["eager"]["max_memory_allocated"],
                            g["graph"]["max_memory_allocated_capture"],
                            g["graph"]["max_memory_allocated"]) / 1e9 for g in got],
               nccl_nodes=[g["graph"]["nccl_nodes"] for g in got],
               losses_finite=finite, ranks_losses_equal=same,
               graph_bit_equal_eager=bit_equal)
        if not (finite and same and bit_equal):
            raise RuntimeError("the ranks' losses are not finite or not equal, or the "
                               "captured turn differs from the eager one")


def main() -> int:
    multihost.initialize()
    rank, world = dist.get_rank(), dist.get_world_size()
    if world < 2:
        raise SystemExit("needs two ranks or more")
    dev = G.resolve_device(torch.device("cuda", torch.cuda.current_device()))
    card = cs.card_line()

    def report(tag, **kw):
        print(json.dumps({"phase": "cards_" + tag, "backend": dist.get_backend(), **kw,
                          "card": card}, default=str), flush=True)

    t0 = time.perf_counter()
    if sys.argv[1:] == ["train"]:
        phase_train(rank, world, dev, report)
    else:
        phase_tp(rank, world, dev, report)
        phase_dp(rank, world, dev, report)
        phase_cp_ring(rank, world, dev, report)
    dist.barrier()
    if rank == 0:
        print(json.dumps({"phase": "cards_done", "seconds": time.perf_counter() - t0,
                          "ranks": world}), flush=True)
        print(card, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
