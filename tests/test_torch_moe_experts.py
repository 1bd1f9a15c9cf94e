"""The grouped expert kernel of the DeepSeek-V2 decode step
(`ops.moe_experts`, `csrc/moe_experts.cu`).

On the CPU: the launch plan and the CTAs' share of the units at the shapes a
decode call can have, the plain version against the reference's per-expert
loop, the hook the benchmark's expert tap patches, and the engine's counter.
On an NVIDIA GPU (tests marked `cuda`, each skipping on a host without a
card: a CUDA kernel has no CPU mode) the kernel against its plain version at
DeepSeek-V2-Lite's expert shapes (64 experts, H 2 048, F 1 408):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_experts.py

This file imports neither JAX nor the JAX package.
"""
import dataclasses
import types

import pytest
import torch

from portbench.reference import deepseek_v2 as RD
from vibevoice_tpu_torch import configs as C
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import deepseek_v2 as D
from vibevoice_tpu_torch.models import qwen2
from vibevoice_tpu_torch.ops import moe_experts as M
from vibevoice_tpu_torch.utils.profiling import Tracer

E, H, F = 64, 2048, 1408   # DeepSeek-V2-Lite's experts
SMS = 132                  # the H100's SMs


def tiny_decoder() -> C.DeepseekV2Config:
    """Hidden 64, 8 experts of 24 top-2 and 1 shared, layer 0 dense."""
    return C.DeepseekV2Config(
        vocab_size=320, hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8,
        n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=16, v_head_dim=16, max_position_embeddings=1024, rope_factor=4.0,
        original_max_position_embeddings=32)


def ref_decoder(dec):
    names = {f.name for f in dataclasses.fields(RD.DeepseekV2Config)}
    return RD.DeepseekV2Config(**{k: v for k, v in vars(dec).items() if k in names})


def _expert_layer(dec, seed=0):
    g = torch.Generator().manual_seed(seed)
    return D.init(dec, torch.float32, device="cpu", generator=g)["layers"][1]


def _tied_router(lp, h0):
    """Router columns 2, 5 and 6 equal and turned to the token h0: for it
    the three tie at the top, one more than the top-2 takes."""
    lp["router"][:, [2, 5, 6]] = (3 * h0 / h0.norm())[:, None]
    return lp


# ---------------------------------------------------------------------------
# CPU: the plan, the schedule, the plain version, the hook, the counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8, 16, 33, 256])
@pytest.mark.parametrize("k", [1, 6, 24, 64])
def test_plan_covers_every_unit_once_inside_the_shapes(n, k):
    """Row groups cover the call's rows once; each launch fits shared memory
    with its rows in one mma tile; its CTAs take every unit (hit expert, F
    tile of 64 columns) exactly once, as evenly as they can, each CTA no more
    than the plan holds a place for, each tile and chunk inside the experts'
    shapes."""
    groups = M.row_groups(n)
    assert [r for n0, nr in groups for r in range(n0, n0 + nr)] == list(range(n))
    nft = -(-F // M.TILE)
    for _, nr in groups:
        p = M.plan(nr, H, F, E, SMS)
        assert 1 <= nr <= p.rg <= M.ROW_GROUP and p.rg in (8, 16)
        assert p.smem <= 227 * 1024 and p.stages >= 2 and p.ctas == SMS
        assert p.smem == M.moe_smem(H, E, p.rg, p.ku, p.stages, p.umax)
        # tensor-map boxes of at most 256 rows in whole k16 steps; a gate/up
        # chunk and a down chunk (32 rows of 512 columns) each fill a stage
        assert p.ku % 16 == 0 and p.ku <= 256 and H % p.ku == 0
        assert 2 * p.ku * M.TILE * 2 == p.stage_bytes == M.DOWN_ROWS * 512 * 2
        assert p.umax * SMS >= E * nft
    for ctas in (SMS, 7):
        sched = M.schedule(k, F, ctas)
        assert len(sched) == ctas
        units = [u for mine in sched for u in mine]
        assert sorted(units) == [(i, j) for i in range(k) for j in range(nft)]
        assert all(j * M.TILE < F for _, j in units)
        sizes = [len(mine) for mine in sched]
        assert max(sizes) - min(sizes) <= 1 and max(sizes) <= -(-E * nft // ctas)


def test_plan_refuses_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        M.plan(17, H, F, E, SMS)          # more than a row group
    with pytest.raises(ValueError):
        M.plan(8, 2000, F, E, SMS)        # H not a multiple of 64
    with pytest.raises(ValueError):
        M.plan(8, H, 1404, E, SMS)        # F not a multiple of 8
    with pytest.raises(ValueError):
        M.plan(8, H, F, 257, SMS)         # more experts than consumer threads
    with pytest.raises(ValueError):
        M.plan(8, H, F, E, 0)             # no CTA fits


@pytest.mark.parametrize("n", [1, 7, 40])
def test_plain_version_equals_the_reference_loop(n):
    """`moe_experts_ref` (every expert, weighed by the zero gate) against the
    reference's loop over each token's experts, on the port's routing with
    ties in the router (to the lower index) and the top-k unnormalised."""
    dec = tiny_decoder()
    lp = _expert_layer(dec)
    h = torch.randn(n, dec.hidden_size, generator=torch.Generator().manual_seed(n))
    h[: (n + 1) // 2] = h[0]
    lp = _tied_router(lp, h[0])
    sel, w = D.route(lp, dec, h)
    assert (sel[0, 2] & sel[0, 5] & ~sel[0, 6]) and (sel.sum(dim=1) == 2).all()
    got = M.moe_experts(h, w, lp["experts_gate"], lp["experts_up"], lp["experts_down"])
    want = RD.routed(lp, ref_decoder(dec), h)
    assert got.dtype == torch.float32 and got.shape == h.shape
    assert torch.allclose(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


def test_the_taps_hook_point_holds(monkeypatch):
    """A decode-sized `moe` call goes through `deepseek_v2._experts_dense`
    looked up by name (the benchmark's `ExpertTap` patches it there), and
    what it returns, the fp32 [N, H] routed sum, is what `moe` adds to the
    shared experts."""
    dec = tiny_decoder()
    lp = _expert_layer(dec, seed=1)
    h = torch.randn(2, 3, dec.hidden_size, generator=torch.Generator().manual_seed(9))
    real, seen = D._experts_dense, []

    def spy(lp_, h_, w_):
        out = real(lp_, h_, w_)
        seen.append((lp_, h_, w_, out))
        return out

    monkeypatch.setattr(D, "_experts_dense", spy)
    got = D.moe(lp, dec, h)
    assert len(seen) == 1 and 6 <= D.DENSE_MAX_TOKENS
    lp_, h2, w, routed = seen[0]
    assert lp_ is lp and tuple(h2.shape) == (6, dec.hidden_size)
    assert torch.equal(w, D.route(lp, dec, h2)[1])
    assert routed.dtype == torch.float32 and tuple(routed.shape) == (6, dec.hidden_size)
    shared = D._swiglu(h2, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    assert torch.equal(got, (routed.to(h.dtype) + shared).reshape(h.shape))
    # a prompt-sized call routes token by token and does not go through it
    monkeypatch.setattr(D, "DENSE_MAX_TOKENS", 4)
    D.moe(lp, dec, h)
    assert len(seen) == 1


def test_engine_counts_the_grouped_layer_steps():
    """`grouped_layers` names every expert layer of a decode-sized call on a
    CUDA device and none on the CPU or past DENSE_MAX_TOKENS; the engine
    counts "moe.grouped_layer_steps" from it per decode step of its [2B]
    rows, and a Qwen2 engine counts nothing."""
    dec = C.DeepseekV2Config()
    assert D.grouped_layers(dec, 8, "cuda") == 26
    assert D.grouped_layers(dec, D.DENSE_MAX_TOKENS + 1, "cuda") == 0
    assert D.grouped_layers(dec, 8, "cpu") == 0
    tr = Tracer()
    eng = types.SimpleNamespace(lm=D, cfg=types.SimpleNamespace(decoder=dec), batch=4,
                                device=torch.device("cuda"))
    G.Engine._count_grouped_steps(eng, tr, 32)
    assert tr.counters["moe.grouped_layer_steps"] == 32 * 26
    big = types.SimpleNamespace(lm=D, cfg=eng.cfg, batch=200, device=eng.device)
    G.Engine._count_grouped_steps(big, tr, 32)  # 400 rows: routed token by token
    G.Engine._count_grouped_steps(types.SimpleNamespace(lm=qwen2, cfg=eng.cfg, batch=4,
                                                        device=eng.device), tr, 32)
    assert dict(tr.counters) == {"moe.grouped_layer_steps": 32 * 26}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture()
def experts(cuda_device):
    """A layer's experts at DeepSeek-V2-Lite's shapes, N(0, 0.02) in bf16
    (1.1 GB, made once per test)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)

    def nrm(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=cuda_device)).to(torch.bfloat16)
    return nrm(E, H, F), nrm(E, H, F), nrm(E, F, H)


def _rows(dev, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, H), generator=gen, device=dev).to(torch.bfloat16)


def _routing(dev, n, seed, k=6):
    """w [n, E] fp32: each row's softmax weight on its top k of random
    scores, zero elsewhere (the model's routing, unnormalised)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.softmax(torch.randn((n, E), generator=gen, device=dev), dim=-1)
    top = scores.topk(k, dim=-1).indices
    return torch.zeros_like(scores).scatter_(1, top, scores.gather(1, top))


def _errors(h, w, ex):
    """(kernel's, plain bf16 version's) largest error against the plain
    version in fp32 on the same bf16 operands, and that version's largest
    value."""
    got = M.moe_experts(h, w, *ex)
    plain = M.moe_experts_ref(h, w, *ex)
    exact = M.moe_experts_ref(h.float(), w, *(t.float() for t in ex))
    err = lambda x: (x - exact).abs().max().item()
    return got, err(got), err(plain), exact.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 8, 16, 64, 256])
def test_kernel_matches_plain(cuda_device, experts, n):
    """Within two bf16 steps of the largest output of the exact sum, and no
    farther from it than the plain bf16 version (which rounds g, u and y
    where the kernel keeps them in fp32)."""
    h, w = _rows(cuda_device, n, n), _routing(cuda_device, n, n)
    before = M.moe_experts.launches
    got, err, plain_err, top = _errors(h, w, experts)
    assert M.moe_experts.launches - before == -(-n // M.ROW_GROUP)
    assert got.dtype == torch.float32 and got.shape == (n, H) and torch.isfinite(got).all()
    assert err <= 2 ** -7 * top, (err, top)
    assert err <= plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["same_six", "every_expert", "a_zero_weight"])
def test_kernel_routings(cuda_device, experts, case):
    """Every row on the same 6 experts (K = 6); every expert hit (K = 64);
    one selected expert's weight exactly 0 (not read: it adds 0 either way)."""
    n = 16
    h, w = _rows(cuda_device, n, 3), _routing(cuda_device, n, 3)
    if case == "same_six":
        w = _routing(cuda_device, 1, 4).expand(n, -1).contiguous()
    elif case == "every_expert":
        w = torch.zeros_like(w)
        for r in range(n):
            w[r, 4 * r:4 * r + 4] = 0.1 + 0.01 * r
    else:
        e = int(w[0].nonzero()[0])
        w[:, e] = 0.0
    got, err, plain_err, top = _errors(h, w, experts)
    assert err <= 2 ** -7 * top and err <= plain_err, (err, plain_err, top)
    if case == "a_zero_weight":
        alone = M.moe_experts(h, w.clone(), *experts)
        assert torch.equal(got, alone)


@pytest.mark.cuda
def test_kernel_two_calls_equal_bits(cuda_device, experts):
    h, w = _rows(cuda_device, 8, 5), _routing(cuda_device, 8, 5)
    a = M.moe_experts(h, w, *experts)
    b = M.moe_experts(h, w, *experts)
    assert torch.equal(a, b)


def _captured(fn):
    """fn captured in a CUDA graph (kept, for its nodes) after a warm call
    on the capture's stream, which makes that stream's workspace."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    graph.instantiate()
    return graph, out


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_follows_the_routing(cuda_device, experts):
    """Captured once and replayed with another routing written into w
    between replays (as each decode step routes anew): each replay equals
    an eager call on that routing, bit for bit."""
    n = 8
    h = _rows(cuda_device, n, 6)
    w = _routing(cuda_device, n, 6)
    graph, out = _captured(lambda: M.moe_experts(h, w, *experts))
    for seed in (11, 12, 13):
        w.copy_(_routing(cuda_device, n, seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, M.moe_experts(h, w, *experts)), seed


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 64])
def test_kernel_nodes_a_call(cuda_device, experts, n):
    """A call's nodes in a captured graph: one kernel node per 16 rows and
    nothing else (the workspace and the output need no memset or copy)."""
    from chip_smoke import graph_kernels
    h, w = _rows(cuda_device, n, 7), _routing(cuda_device, n, 7)
    graph, _ = _captured(lambda: M.moe_experts(h, w, *experts))
    names = graph_kernels(graph)
    assert len(names) == -(-n // M.ROW_GROUP)
    assert all("18moe_experts_kernel" in x for x in names), names


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_read(cuda_device, experts):
    gate, up, down = experts
    h, w = _rows(cuda_device, 8, 8), _routing(cuda_device, 8, 8)
    shifted = torch.empty(h.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    h_off = shifted[1:1 + h.numel()].view(h.shape)  # 2 bytes into a 16-byte unit
    with pytest.raises(ValueError, match="16-byte"):
        M.moe_experts(h_off, w, gate, up, down)
    with pytest.raises(ValueError, match="contiguous"):
        M.moe_experts(h, w, gate.transpose(1, 2).contiguous().transpose(1, 2), up, down)
    with pytest.raises(TypeError):  # fp32 rows
        M.moe_experts(h.float(), w, gate, up, down)
    with pytest.raises(TypeError):  # bf16 gate weights
        M.moe_experts(h, w.to(torch.bfloat16), gate, up, down)
    with pytest.raises(ValueError):  # down of the wrong shape
        M.moe_experts(h, w, gate, up, up)
