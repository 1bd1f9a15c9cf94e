"""The port on an NVIDIA GPU: the hand-written kernels against their plain
PyTorch versions, and a small engine on the card against the same engine on
the CPU.  Each test skips on a host without a card.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.models.qwen2 import _quantize_slots
from vibevoice_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return G.resolve_device("cuda")


def _device_kernels(fn):
    """(fn's result, the names of what one call of fn ran on the device).  fn
    runs once on a side stream (which makes the wrappers' workspaces of that
    stream), then once more captured in a CUDA graph that is never replayed:
    the graph's nodes are the kernels (and copies or fills) of one call.
    torch.profiler is not used: on the H100's card image (torch 2.11) its
    traces lost every device kernel at random points of a process, after
    other work on the card."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    from chip_smoke import graph_kernels
    return out, graph_kernels(graph)


def _graph_nodes(eng):
    """Kernel nodes by wrapper of an engine's captured decode step."""
    from chip_smoke import graph_launches
    assert eng.graph is not None, "the engine decoded without its captured step"
    return graph_launches(eng.graph)[0]


def _cache(n_layers, b, s, f, quant, gen, dev):
    k = torch.randn((n_layers, b, s, f), generator=gen, device=dev)
    v = torch.randn((n_layers, b, s, f), generator=gen, device=dev)
    if not quant:
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    kq, ks = _quantize_slots(k.view(n_layers * b, s, f))
    vq, vs = _quantize_slots(v.view(n_layers * b, s, f))
    wide = lambda x: x.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous()
    return kq.view(k.shape), vq.view(v.shape), wide(ks), wide(vs)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_matches_plain(cuda_device, quant):
    """1.5B shapes: H=12, KVH=2, D=128, L=28, S=4096; layers 0 and 27; one
    partial and one full row; holes like a negative-stream reset leaves."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    s = 4096
    q = torch.randn((2, 12, 128), generator=gen, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(28, 2, s, 256, quant, gen, dev)
    lengths = torch.tensor([1500, s], dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    vis[1, 1:40] = 0
    vis[1, 999] = 0
    before = da.decode_attention.launches
    for layer in (0, 27):
        got = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, layer, vis, lengths, ks, vs)
        # both round to bf16 (|out| < 0.5: one step ~2e-3) after fp32 sums
        # taken in another order
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=0)
    assert da.decode_attention.launches == before + 2


def _attention(dev, gen, s, lengths, quant, h, kvh, n_layers=2):
    q = torch.randn((len(lengths), h, 128), generator=gen, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(n_layers, len(lengths), s, kvh * 128, quant, gen, dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    return q, k, v, ks, vs, vis, lengths


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["7b-g7", "40k-live"])
def test_decode_attention_7b_grouping_and_long_cache(cuda_device, case, quant):
    """The 7B grouping (H=28, KVH=4, G=7) at S=4096, and a 90-minute request:
    40 000 live slots of a 40 960-slot cache (a few layers)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    s, lengths, h, kvh = ((4096, [1500, 4096], 28, 4) if case == "7b-g7"
                          else (40960, [40000, 40000], 12, 2))
    q, k, v, ks, vs, vis, lengths = _attention(cuda_device, gen, s, lengths, quant, h, kvh)
    vis[1, 1:40] = 0
    for layer in (0, 1):
        got = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, layer, vis, lengths, ks, vs)
        # bf16 P in P.V (2^-9 of each weight) and bf16 outputs (|out| < 0.5)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=0)


def test_decode_attention_rows_that_see_nothing_are_zero(cuda_device):
    """A row whose live length is 0, and one whose live slots are all
    masked, return zeros; the other rows are unaffected."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, ks, vs, vis, lengths = _attention(cuda_device, gen, 4096, [0, 2000, 3000, 4096],
                                               False, 12, 2)
    vis[1] = 0
    got = da.decode_attention(q, k, v, 1, vis, lengths)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[:2]) == 0
    want = da.decode_attention_ref(q, k, v, 1, vis, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=0)


def test_decode_attention_counters_reset_between_calls(cuda_device):
    """Back-to-back calls with other live lengths (other numbers of splits
    with work) on the cached workspace: each merges its own splits, so the
    ticket counters are back at 0 after every call."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, ks, vs, vis, _ = _attention(cuda_device, gen, 4096, [4096, 4096], True, 12, 2)
    for lens in ([4096, 100], [7, 4096], [0, 2000], [4096, 4096], [64, 65]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        got = da.decode_attention(q, k, v, 0, vis, lengths, ks, vs)
        want = da.decode_attention_ref(q, k, v, 0, vis, lengths, ks, vs)
        # a row of a few slots averages few values, so its outputs reach 1-2:
        # one bf16 step of the largest output, at least the 2e-3 of |out| < 0.5
        tol = max(2e-3, 2 ** -7 * float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    _, _, counters = da.workspace(cuda_device, torch.cuda.current_stream().cuda_stream, 2, 2,
                                  da.plan(2, 2, 4096, torch.bfloat16,
                                          torch.cuda.get_device_properties(0).multi_processor_count,
                                          torch.int8),
                                  6, 128)
    assert not counters.any()


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_is_one_deterministic_launch(cuda_device, quant):
    """A call is one kernel on the device (the splits meet in the last CTA of
    each row and KV head), and two calls give the same bits (the partials are
    merged in split order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, ks, vs, vis, lengths = _attention(cuda_device, gen, 8192, [5000, 8192], quant,
                                               12, 2)
    first = da.decode_attention(q, k, v, 1, vis, lengths, ks, vs)  # builds the library
    torch.cuda.synchronize()
    second, kernels = _device_kernels(
        lambda: da.decode_attention(q, k, v, 1, vis, lengths, ks, vs))
    assert len(kernels) == 1 and "mma_kernel" in kernels[0], kernels
    assert torch.equal(first, second)


def test_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 engine on the long-cache path (head_dim 64, the kernel
    on the card, the plain version on the CPU): equal tokens, audio within
    1e-3 of its scale."""
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, generator=gen, device="cpu")
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for name in ("final_ada_w", "final_linear"):
        head[name] = torch.randn(head[name].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)
    rng = np.random.default_rng(0)
    b, t, steps = 2, 40, 12
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True,
                              max_length_times=64.0)
    runs = {}
    for name, where in (("cpu", "cpu"), ("card", cuda_device)):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_decode=True, device=where)
        before = da.decode_attention.launches
        runs[name] = (G.generate(eng, ids, mask, sim, latent_noise=noise),
                      da.decode_attention.launches - before)
    (ref, cpu_launches), (got, card_launches) = runs["cpu"], runs["card"]
    assert cpu_launches == 0
    # the card decodes through the captured step: the warm-up step and the
    # capture call the wrapper, the replays do not; the graph holds one
    # launch per layer
    n_layers = cfg.decoder.num_hidden_layers
    assert card_launches == 2 * n_layers
    assert _graph_nodes(eng)["decode_attention"] == n_layers
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    assert np.isfinite(a).all() and np.abs(w).max() > 0
    np.testing.assert_allclose(a, w, atol=1e-3 * np.abs(w).max(), rtol=0)


def _rel_tol(want):
    # bf16 outputs: one rounding step of the largest output (2^-7 of it) after
    # fp32 sums taken in another order
    return 2 ** -7 * float(want.float().abs().max())


@pytest.mark.parametrize("group_size", [None, 128])
@pytest.mark.parametrize("m,k,n", [(2, 1536, 2048), (2, 8960, 1536), (64, 1536, 1536),
                                   (1, 1536, 1000), (128, 1536, 2048), (2, 1536, 17920)])
def test_int4_matmul_kernel_matches_plain(cuda_device, group_size, m, k, n):
    """The 1.5B projections at M=2, M=1 with N not a multiple of 16, and
    M=64 / 128 (several CTAs of 16 rows each)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = im.quantize_int4(torch.randn((k, n), generator=gen, device=cuda_device) * 0.02,
                         group_size)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = im.int4_matmul.launches
    got = im.int4_matmul(x, q["qint4"], q["scale4"])
    torch.cuda.synchronize()
    want = im.int4_matmul_ref(x, q["qint4"], q["scale4"])
    assert im.int4_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=_rel_tol(want), rtol=0)


@pytest.mark.parametrize("group_size", [None, 128])
def test_int4_matmul_is_one_deterministic_launch(cuda_device, group_size):
    """Two calls on the same inputs give the same bits (the K splits are added
    in a fixed order, no float atomics), and a call is one kernel on the
    device (the splits meet inside the launch)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = im.quantize_int4(torch.randn((8960, 1536), generator=gen, device=cuda_device) * 0.02,
                         group_size)
    x = torch.randn((2, 8960), generator=gen, device=cuda_device).to(torch.bfloat16)
    first = im.int4_matmul(x, q["qint4"], q["scale4"])  # builds and loads the library
    assert im.plan(2, 8960, 1536)[1] > 1  # splits that meet in a cluster
    torch.cuda.synchronize()
    second, kernels = _device_kernels(lambda: im.int4_matmul(x, q["qint4"], q["scale4"]))
    assert len(kernels) == 1 and "int4_matmul" in kernels[0], kernels
    assert torch.equal(first, second)


def _stage(d, n, gen, dev):
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    return [{"norm_w": 1 + 0.1 * r(d), "mixer": {"w": 0.2 * r(7, 1, d), "b": 0.1 * r(d)},
             "gamma": 0.3 * r(d), "ffn_norm_w": 1 + 0.1 * r(d),
             "ffn1": {"w": 0.05 * r(d, 4 * d), "b": 0.1 * r(4 * d)},
             "ffn2": {"w": 0.05 * r(4 * d, d), "b": 0.1 * r(d)}, "ffn_gamma": 0.3 * r(d)}
            for _ in range(n)]


@pytest.mark.parametrize("b,t,d,n", [(1, 1, 2048, 8), (1, 8, 1024, 3), (4, 8, 1024, 3),
                                     (2, 5, 8, 2)])
def test_fused_block_chain_kernel_matches_plain(cuda_device, b, t, d, n):
    """The 1.5B stage shapes (B=1 and one B=4 case) and a tiny ragged one."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    pack = fb.pack_stage_q(_stage(d, n, gen, cuda_device))
    x = (0.5 * torch.randn((b, t, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
    ctx = (0.5 * torch.randn((b, n, 6, d), generator=gen, device=cuda_device)).to(torch.bfloat16)
    before = fb.fused_block_chain_batched.launches
    y, new_ctx = fb.fused_block_chain_batched(pack, x, ctx)
    torch.cuda.synchronize()
    y_ref, ctx_ref = fb.fused_block_chain_batched_ref(pack, x, ctx)
    assert fb.fused_block_chain_batched.launches == before + 1
    torch.testing.assert_close(y.float(), y_ref.float(), atol=_rel_tol(y_ref), rtol=0)
    torch.testing.assert_close(new_ctx.float(), ctx_ref.float(), atol=_rel_tol(ctx_ref), rtol=0)


def _chain_inputs(b, t, d, n, gen, dev):
    x = (0.5 * torch.randn((b, t, d), generator=gen, device=dev)).to(torch.bfloat16)
    ctx = (0.5 * torch.randn((b, n, 6, d), generator=gen, device=dev)).to(torch.bfloat16)
    return x, ctx


@pytest.mark.parametrize("b,t,d,n", [(1, 1, 2048, 8), (1, 8, 1024, 3), (4, 8, 1024, 3)])
def test_fused_block_chain_is_one_deterministic_launch(cuda_device, b, t, d, n):
    """Every sum of the int4 chain runs in a fixed order: two calls on the
    same inputs give the same bits, each one kernel on the device."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    pack = fb.pack_stage_q(_stage(d, n, gen, cuda_device))
    x, ctx = _chain_inputs(b, t, d, n, gen, cuda_device)
    first = fb.fused_block_chain_batched(pack, x, ctx)  # builds and loads the library
    torch.cuda.synchronize()
    second, kernels = _device_kernels(lambda: fb.fused_block_chain_batched(pack, x, ctx))
    assert len(kernels) == 1 and "chain_q_kernel" in kernels[0], kernels
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("b,t,d,n", [(1, 8, 1024, 3), (2, 5, 8, 2)])
def test_fused_block_chain_streams_context(cuda_device, b, t, d, n):
    """Three chunks with the new context carried into the next, against the
    plain version carried the same way."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    pack = fb.pack_stage_q(_stage(d, n, gen, cuda_device))
    got_c = want_c = _chain_inputs(b, t, d, n, gen, cuda_device)[1]
    for _ in range(3):
        x = _chain_inputs(b, t, d, n, gen, cuda_device)[0]
        y, got_c = fb.fused_block_chain_batched(pack, x, got_c)
        torch.cuda.synchronize()
        y_ref, want_c = fb.fused_block_chain_batched_ref(pack, x, want_c)
        torch.testing.assert_close(y.float(), y_ref.float(), atol=_rel_tol(y_ref), rtol=0)
        torch.testing.assert_close(got_c.float(), want_c.float(), atol=_rel_tol(want_c), rtol=0)
        got_c = want_c  # each chunk from the same context, so errors do not compound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d,n", [(3, 5, 24, 2), (2, 3, 352, 2), (5, 8, 1024, 1)])
def test_fused_block_chain_ragged_shapes(cuda_device, dtype, b, t, d, n):
    """Widths that do not fill a cluster evenly: D=24 (3 of a rank's D
    columns, 4-byte W1 copies, byte copies of W2), D=352 (F=1408 on 118 CTAs
    of 12 columns: the last cluster part idle, 16-byte W2 copies), and B=5
    T=8 in three row groups, in bf16 and fp32."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    pack = fb.pack_stage_q(_stage(d, n, gen, cuda_device))
    x, ctx = (v.to(dtype) for v in _chain_inputs(b, t, d, n, gen, cuda_device))
    y, new_ctx = fb.fused_block_chain_batched(pack, x, ctx)
    torch.cuda.synchronize()
    y_ref, ctx_ref = fb.fused_block_chain_batched_ref(pack, x, ctx)
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    # bf16: one rounding step of the largest value; fp32: sums in another order
    scale = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for g, w in ((y, y_ref), (new_ctx, ctx_ref)):
        torch.testing.assert_close(g.float(), w.float(), atol=scale * float(w.float().abs().max()),
                                   rtol=0)


def _head_case(n, h, f, dtype, dev, seed=3):
    from vibevoice_tpu_torch.ops import fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    head = {"layers": [{"norm_w": 1 + 0.1 * r(h), "gate": 0.03 * r(h, f), "up": 0.03 * r(h, f),
                        "down": 0.03 * r(f, h)} for _ in range(4)]}
    pack = fh.pack_head_solver_q(head)
    x, mods = r(n, h).to(dtype), (0.3 * r(4, n, 3 * h)).to(dtype)
    fmod, fl = (0.3 * r(n, 2 * h)).to(dtype), (0.05 * r(h, 64)).to(dtype)
    return pack, x, mods, fmod, fl


# (N, H, F): the 1.5B head at B=1 and B=4, the 7B head, a ragged small one,
# and N=12 at 1.5B in two row groups (8 + 4 rows)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,f", [(2, 1536, 4608), (8, 1536, 4608), (2, 3584, 10752),
                                   (6, 64, 192), (12, 1536, 4608)])
def test_fused_head_kernel_matches_plain(cuda_device, n, h, f, dtype):
    from vibevoice_tpu_torch.ops import fused_head as fh
    pack, x, mods, fmod, fl = _head_case(n, h, f, dtype, cuda_device)
    before = fh.fused_head_solver_step.launches
    got = fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    torch.cuda.synchronize()
    want = fh.fused_head_solver_step_ref(pack, x, mods, fmod, fl, 1e-5)
    assert fh.fused_head_solver_step.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_rel_tol(want), rtol=0)


def test_fused_head_two_calls_equal(cuda_device):
    """The sums run in a fixed order (shares in rank order, partials in
    cluster order): two calls on the same inputs give the same bits."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    pack, x, mods, fmod, fl = _head_case(2, 1536, 4608, torch.bfloat16, cuda_device)
    a = fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    b = fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_fused_head_replays_in_a_cuda_graph(cuda_device):
    """The kernel captured in a CUDA graph and replayed three times gives the
    eager call's bits: the grid barrier's counter and the cached workspace
    survive replay."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    pack, x, mods, fmod, fl = _head_case(2, 1536, 4608, torch.bfloat16, cuda_device)
    want = fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):  # the capture stream's workspace, made eagerly
        fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = fh.fused_head_solver_step(pack, x, mods, fmod, fl, 1e-5)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _bf16_head_case(n, h, f, dev, seed=5):
    """A 4-layer bf16 head's own tensors (the route's pack), x after
    noisy_proj, one solver step's modulations and the final linear."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    head = {"layers": [{"norm_w": (1 + 0.1 * r(h)).to(bf), "gate": (0.03 * r(h, f)).to(bf),
                        "up": (0.03 * r(h, f)).to(bf), "down": (0.03 * r(f, h)).to(bf)}
                       for _ in range(4)]}
    return (fhb.pack(head), r(n, h).to(bf), (0.3 * r(4, n, 3 * h)).to(bf),
            (0.3 * r(n, 2 * h)).to(bf), (0.05 * r(h, 64)).to(bf))


# (N, H, F): the 1.5B head at B=1, 4 and 8 and at N=20 (row groups of 16 and
# 4), the Large head at B=1, 4 and 8
@pytest.mark.parametrize("n,h,f", [(2, 1536, 4608), (8, 1536, 4608), (16, 1536, 4608),
                                   (20, 1536, 4608), (2, 3584, 10752), (8, 3584, 10752),
                                   (16, 3584, 10752)])
def test_fused_head_bf16_kernel_matches_plain(cuda_device, n, h, f):
    """The bf16 head kernel against its plain version, which makes the same
    roundings (x fp32 across the layers, h and the activations rounded to
    bf16) with fp32 sums in another order; the output is bf16, so the
    tolerance is one rounding step of the largest output (2^-7 of it)."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    pk, x, mods, fmod, fl = _bf16_head_case(n, h, f, cuda_device)
    before = fhb.fused_head_bf16_step.launches
    got = fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5)
    torch.cuda.synchronize()
    want = fhb.fused_head_bf16_step_ref(pk, x, mods, fmod, fl, 1e-5)
    assert fhb.fused_head_bf16_step.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_rel_tol(want), rtol=0)


@pytest.mark.parametrize("shift", [1, 3, 7])
@pytest.mark.parametrize("n,h,f", [(16, 1536, 4608), (8, 3584, 10752)])
def test_fused_head_bf16_on_weights_inside_one_buffer(cuda_device, n, h, f, shift):
    """The weights as views into one buffer, each starting `shift` elements
    into a 16-byte unit (the benchmark makes its weights so): against the
    plain version at `test_fused_head_bf16_kernel_matches_plain`'s
    tolerance, as the same weights on their own are (the CTAs then take
    other columns, so the down projection's sums meet in another order and
    the bits may differ)."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    pk, x, mods, fmod, fl = _bf16_head_case(n, h, f, cuda_device)
    tensors = [t for k in ("gate", "up", "down", "norm_w") for t in pk[k]] + [fl]
    buf = torch.zeros(sum(t.numel() for t in tensors) + 8 * len(tensors) + shift,
                      dtype=torch.bfloat16, device=cuda_device)
    views, at = [], shift
    for t in tensors:  # each view shift (mod 8) elements into a unit
        views.append(buf[at:at + t.numel()].view(t.shape))
        views[-1].copy_(t)
        at += -(-t.numel() // 8) * 8 + 8
    nl = len(pk["gate"])
    shifted = {k: views[i * nl:(i + 1) * nl] for i, k in enumerate(("gate", "up", "down", "norm_w"))}
    assert all(v.data_ptr() % 16 == 2 * shift for v in views)
    want = fhb.fused_head_bf16_step_ref(pk, x, mods, fmod, fl, 1e-5)
    got = fhb.fused_head_bf16_step(shifted, x, mods, fmod, views[-1], 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_rel_tol(want), rtol=0)
    assert torch.equal(got, fhb.fused_head_bf16_step(shifted, x, mods, fmod, views[-1], 1e-5))


@pytest.mark.parametrize("n,h,f", [(16, 1536, 4608), (8, 3584, 10752)])
def test_fused_head_bf16_on_weights_packed_unpadded(cuda_device, n, h, f):
    """The weights packed into one buffer with no room after the last: each
    layer's gate and up 3 elements into a 16-byte unit, down 5, the norms 6
    and final_linear 7, which ends the buffer.  The engine takes the route for
    such a head; the kernel agrees with the plain version at
    `test_fused_head_bf16_kernel_matches_plain`'s tolerance, two calls give
    the same bits, and a layer whose gate and up start at different offsets
    raises rather than running."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    pk, x, mods, fmod, fl = _bf16_head_case(n, h, f, cuda_device)
    keys = ("gate", "up", "down", "norm_w")
    tensors = [t for k in keys for t in pk[k]] + [fl]
    nl = len(pk["gate"])
    gaps = [3] + [0] * (2 * nl - 1) + [2] + [0] * (nl - 1) + [1] + [0] * (nl - 1) + [1]
    buf = torch.zeros(sum(t.numel() for t in tensors) + sum(gaps), dtype=torch.bfloat16,
                      device=cuda_device)
    views, at = [], 0
    for t, gap in zip(tensors, gaps):
        at += gap
        views.append(buf[at:at + t.numel()].view(t.shape))
        views[-1].copy_(t)
        at += t.numel()
    assert at == buf.numel()
    packed = {k: views[i * nl:(i + 1) * nl] for i, k in enumerate(keys)}
    assert [{v.data_ptr() % 16 // 2 for v in packed[k]} for k in keys] == [{3}, {3}, {5}, {6}]
    assert views[-1].data_ptr() % 16 == 14
    head = {"layers": [dict(zip(keys, lw)) for lw in zip(*(packed[k] for k in keys))],
            "final_linear": views[-1]}
    assert fhb.takes(head, cuda_device)
    want = fhb.fused_head_bf16_step_ref(pk, x, mods, fmod, fl, 1e-5)
    got = fhb.fused_head_bf16_step(packed, x, mods, fmod, views[-1], 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_rel_tol(want), rtol=0)
    assert torch.equal(got, fhb.fused_head_bf16_step(packed, x, mods, fmod, views[-1], 1e-5))
    before = fhb.fused_head_bf16_step.launches
    with pytest.raises(ValueError, match="same offset"):
        fhb.fused_head_bf16_step(dict(packed, up=pk["up"]), x, mods, fmod, views[-1], 1e-5)
    assert fhb.fused_head_bf16_step.launches == before


@pytest.mark.parametrize("h,f", [(1536, 4608), (3584, 10752)])
def test_fused_head_bf16_two_calls_equal(cuda_device, h, f):
    """The sums run in a fixed order (mma k-steps in order, partials in
    cluster order, the final sums in rank order): two calls on the same
    inputs give the same bits, and it is one kernel a call."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    pk, x, mods, fmod, fl = _bf16_head_case(16, h, f, cuda_device)
    a, kernels = _device_kernels(lambda: fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5))
    b = fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5)
    torch.cuda.synchronize()
    assert len(kernels) == 1 and "head_bf16_kernel" in kernels[0], kernels
    assert torch.equal(a, b)


@pytest.mark.parametrize("h,f", [(1536, 4608), (3584, 10752)])
def test_fused_head_bf16_replays_in_a_cuda_graph(cuda_device, h, f):
    """The kernel captured in a CUDA graph and replayed three times gives the
    eager call's bits: the grid barrier's counter and the cached workspace
    survive replay."""
    from vibevoice_tpu_torch.ops import fused_head_bf16 as fhb
    pk, x, mods, fmod, fl = _bf16_head_case(16, h, f, cuda_device)
    want = fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):  # the capture stream's workspace, made eagerly
        fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = fhb.fused_head_bf16_step(pk, x, mods, fmod, fl, 1e-5)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_quantized_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model in the int4 serving modes (int4 LM with group
    scales, int4k tokenizer chains, int4k head): every int4 kernel on the
    card, the plain versions on the CPU; equal tokens, audio within 1e-3 of
    its scale."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_head as fh, int4_matmul as im
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, generator=gen, device="cpu")
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for name in ("final_ada_w", "final_linear"):
        head[name] = torch.randn(head[name].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)
    tts = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.float32, device="cpu",
                       quantize="int4", int4_group_size=32, quantize_tokenizer="int4k",
                       quantize_diffusion="int4k", tokenizer_min_dim=4)
    rng = np.random.default_rng(0)
    b, t, steps = 2, 72, 8  # a 144-row prompt: prefill takes the dequantized route
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True,
                              max_length_times=64.0)
    counters = (im.int4_matmul, fb.fused_block_chain_batched, fh.fused_head_solver_step)
    runs = {}
    for name, where in (("cpu", "cpu"), ("card", cuda_device)):
        eng = G.Engine(tts.params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, device=where)  # the tree's int4 chains
        before = [c.launches for c in counters]
        res = G.generate(eng, ids, mask, sim, latent_noise=noise)
        runs[name] = (res, [c.launches - n for c, n in zip(counters, before)])
    (ref, cpu_launches), (got, card_launches) = runs["cpu"], runs["card"]
    assert cpu_launches == [0, 0, 0]
    n_layers = cfg.decoder.num_hidden_layers
    # prefill's negative-stream forward (M=B) and every decode step run 4 int4
    # GEMVs per layer; every step diffuses: 4 chain stages, 3 solver steps.
    # Through the wrappers: the prefill, the warm-up step and the captured
    # one; the graph holds one step's launches
    assert card_launches == [3 * 4 * n_layers, 3 * 6, 3 * 3]
    nodes = _graph_nodes(eng)
    assert [nodes[k] for k in ("int4_matmul", "fused_block_chain_batched",
                               "fused_head_solver_step")] == [4 * n_layers, 6, 3]
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    assert np.isfinite(a).all() and np.abs(w).max() > 0
    np.testing.assert_allclose(a, w, atol=1e-3 * np.abs(w).max(), rtol=0)


# the large-T stage kernels: (B, stage T, D, blocks, fold conv (kind, s, k, cin),
# fold head, row-lane R); the 1.5B stage shapes (some cut in T), tiny fp32 ones,
# and rows that are not whole 16-byte vectors (bf16 D=4, fp32 D=6: the
# kernel's narrow copies)
STAGE_CASES = {
    "dec3-up": (1, 200, 256, 3, ("up", 5, 10, 512), False, None),
    "dec6-up": (1, 800, 32, 3, ("up", 2, 4, 64), False, None),
    "dec6-up-head": (1, 800, 32, 3, ("up", 2, 4, 64), True, None),
    "enc0-stem": (1, 800, 32, 3, ("down", 1, 7, 1), False, None),
    "enc3-down": (1, 200, 256, 3, ("down", 4, 8, 128), False, None),
    "plain-b2": (2, 400, 128, 3, None, False, None),
    "rowlane-r2": (2, 800, 32, 3, None, False, 2),
    "rowlane-r3": (3, 800, 32, 3, None, False, 3),
    "rowlane-r4": (4, 400, 32, 2, None, False, 4),
    "rowlane-d64": (4, 400, 64, 2, None, False, 2),
    "tiny-up-fp32": (1, 16, 4, 1, ("up", 2, 4, 8), True, None),
    "tiny-rowlane-fp32": (2, 8, 8, 1, None, False, 2),
    "rowlane-d4": (2, 64, 4, 2, None, False, 2),
    "narrow-d4": (2, 64, 4, 2, None, False, None),
    "narrow-d6-fp32": (2, 64, 6, 2, None, False, None),
    "narrow-up-head-d6-fp32": (1, 16, 6, 1, ("up", 2, 4, 8), True, None),
}
ROWLANE_CASES = [c for c, spec in STAGE_CASES.items() if spec[6]]


def _stage_case(case, dev, gen):
    dt = torch.float32 if case.endswith("fp32") else torch.bfloat16
    return _stage_inputs(STAGE_CASES[case], dt, dev, gen)


def _stage_inputs(spec, dt, dev, gen):
    from vibevoice_tpu_torch.ops import fused_stage as fs
    b, t, d, n, conv, head, r = spec
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)
    blocks = _stage(d, n, gen, dev)
    pack = fs.pack_stage(blocks, dtype=dt)
    xshape, state = (b, t, d), None
    if r:
        pack["rowlane"] = fs.pack_stage_rowlane(blocks, r, dtype=dt)
    if conv:
        kind, s, k, cin = conv
        if kind == "up":
            pack["conv"] = fs.pack_up_conv({"w": 0.05 * rn(cin, k, d), "b": 0.1 * rn(d)}, s, dt)
            xshape, state = (b, t // s, cin), ("conv_state", (b, s, d))
        else:
            pack["conv"] = fs.pack_down_conv({"w": 0.3 * rn(k, cin, d) / cin ** 0.5,
                                              "b": 0.1 * rn(d)}, s, dt)
            xshape, state = (b, t * s, cin), ("conv_state", (b, k - s, cin))
    states = {} if state is None else {state[0]: (0.5 * rn(*state[1])).to(dt)}
    if head:
        pack["head"] = fs.pack_head({"w": 0.1 * rn(7, d, 1), "b": 0.1 * rn(1)}, 1 + 0.1 * rn(d))
        states["head_state"] = (0.5 * rn(b, 6, d)).to(dt)
    ctx = (0.5 * rn(b, n, 6, d)).to(dt)
    xs = [(0.5 * rn(*xshape)).to(dt) for _ in range(2)]
    return pack, xs, ctx, states


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_fused_stage_kernels_match_plain(cuda_device, case):
    """Each fold and row-lane layout, over two chunks: the kernel's returned
    states feed its next call, the plain version's its own."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    pack, xs, ctx, states = _stage_case(case, cuda_device, gen)
    rowlane = STAGE_CASES[case][6] is not None
    counter = fs.fused_stage_chain_rowlane if rowlane else fs.fused_stage_chain
    plain = fs.fused_stage_chain_rowlane_ref if rowlane else fs.fused_stage_chain_ref
    names = list(states)
    got_st, want_st = (ctx, *states.values()), (ctx, *states.values())
    for x in xs:
        before = counter.launches
        got = fs.fused_stage_chain(pack, x, got_st[0], **dict(zip(names, got_st[1:])))
        torch.cuda.synchronize()
        want = plain(pack, x, want_st[0], **dict(zip(names, want_st[1:])))
        assert counter.launches == before + 1
        assert len(got) == len(want) == 2 + len(names)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.isfinite(g).all()
            # bf16: one rounding step of the largest value; fp32: sums in
            # another order, over three blocks and two chunks
            tol = (1e-4 if g.dtype == torch.float32 else 2 ** -7) * float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
        got_st, want_st = got[1:], want[1:]


def _without_rowlane(pack):
    return {k: v for k, v in pack.items() if k != "rowlane"}


@pytest.mark.parametrize("case", ROWLANE_CASES)
def test_rowlane_kernel_equals_stage_kernel_on_the_same_rows(cuda_device, case):
    """The row-lane kernel reads each batch item's diagonal blocks and takes
    each row's norm over its own D channels: the stage kernel's products and
    sums in the same order, so its outputs are bit-equal to the stage
    kernel's on the pack without its row-lane entry, over two chunks."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    pack, xs, ctx, _ = _stage_case(case, cuda_device, gen)
    plain_pack = _without_rowlane(pack)
    got_c = want_c = ctx
    for x in xs:
        before = (fs.fused_stage_chain_rowlane.launches, fs.fused_stage_chain.launches)
        got = fs.fused_stage_chain(pack, x, got_c)
        assert (fs.fused_stage_chain_rowlane.launches, fs.fused_stage_chain.launches) == (
            before[0] + 1, before[1])
        want = fs.fused_stage_chain(plain_pack, x, want_c)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got_c, want_c = got[1], want[1]


@pytest.mark.parametrize("case", ["rowlane-r2", "rowlane-r4", "rowlane-d4"])
def test_rowlane_kernel_is_one_deterministic_launch(cuda_device, case):
    """A row-lane call is one `cluster_kernel` launch on the device, with no
    copy or relayout kernel around it, and two calls give the same bits."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    pack, xs, ctx, _ = _stage_case(case, cuda_device, gen)
    first = fs.fused_stage_chain(pack, xs[0], ctx)
    second, kernels = _device_kernels(lambda: fs.fused_stage_chain(pack, xs[0], ctx))
    assert len(kernels) == 1 and "cluster_kernel" in kernels[0], kernels
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_rowlane_kernel_replays_in_a_cuda_graph(cuda_device):
    """The row-lane call captured in a CUDA graph and replayed three times
    gives the eager call's bits: the grid barrier's counter and the cached
    scratch survive replay."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    pack, xs, ctx, _ = _stage_case("rowlane-r4", cuda_device, gen)
    want = fs.fused_stage_chain(pack, xs[0], ctx)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):  # the capture stream's scratch, made eagerly
        fs.fused_stage_chain(pack, xs[0], ctx)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = fs.fused_stage_chain(pack, xs[0], ctx)
    for _ in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# the eight folded B=1 stage calls of a 1.5B decode step with
# `use_fused_stages` (3 blocks each): (stage T, D, fold conv (kind, s, k, cin))
STEP_STAGES = {
    "dec3": (200, 256, ("up", 5, 10, 512)), "dec4": (800, 128, ("up", 4, 8, 256)),
    "dec5": (1600, 64, ("up", 2, 4, 128)), "dec6": (3200, 32, ("up", 2, 4, 64)),
    "enc0": (3200, 32, ("down", 1, 7, 1)), "enc1": (1600, 64, ("down", 2, 4, 32)),
    "enc2": (800, 128, ("down", 2, 4, 64)), "enc3": (200, 256, ("down", 4, 8, 128)),
}


@pytest.mark.parametrize("case", list(STEP_STAGES))
def test_stage_kernel_step_shapes_one_deterministic_launch(cuda_device, case):
    """The step's eight stage shapes over two chunks (states carried) against
    the plain version; each call is one kernel on the device, and two calls
    on the same inputs give the same bits (the FFN shares are added in rank
    order)."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    t, d, conv = STEP_STAGES[case]
    pack, xs, ctx, states = _stage_inputs((1, t, d, 3, conv, False, None), torch.bfloat16,
                                          cuda_device,
                                          torch.Generator(device=cuda_device).manual_seed(9))
    st = (ctx, states["conv_state"])
    want_st = st
    for x in xs:
        got = fs.fused_stage_chain(pack, x, st[0], conv_state=st[1])
        want = fs.fused_stage_chain_ref(pack, x, want_st[0], conv_state=want_st[1])
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=2 ** -7 * float(w.float().abs().max()))
        st, want_st = got[1:], want[1:]
    torch.cuda.synchronize()
    again, kernels = _device_kernels(
        lambda: fs.fused_stage_chain(pack, xs[1], ctx, conv_state=states["conv_state"]))
    assert len(kernels) == 1 and "cluster_kernel" in kernels[0], kernels
    first = fs.fused_stage_chain(pack, xs[1], ctx, conv_state=states["conv_state"])
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# flash prefill: (B, T, S, H, KVH, D, left pad of the last row, row_offset, dtype,
# causal, scale of q and k)
FLASH_CASES = {
    "1.5b-pad": (2, 1024, 1024, 12, 2, 128, 333, None, torch.bfloat16, True, 0.5),
    "1.5b-shard": (2, 384, 1408, 12, 2, 128, 77, 1024, torch.bfloat16, True, 0.5),
    "d64-fp32": (2, 200, 200, 4, 2, 64, 37, None, torch.float32, True, 0.5),
    "d64-bf16": (2, 300, 300, 4, 2, 64, 37, None, torch.bfloat16, True, 0.5),
    "7b-g7-pad": (2, 1000, 1000, 28, 4, 128, 333, None, torch.bfloat16, True, 0.5),
    "non-causal": (2, 300, 300, 12, 2, 128, 37, None, torch.bfloat16, False, 0.5),
    "1.5b-peaked": (1, 1024, 1024, 12, 2, 128, 0, None, torch.bfloat16, True, 2.0),
    # a context-parallel rank's half of an 8192-token prompt (the second)
    "1.5b-cp-half": (1, 4096, 8192, 12, 2, 128, 0, 4096, torch.bfloat16, True, 0.5),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_prefill_kernel_matches_plain(cuda_device, case):
    """A left-padded row (a pad count that is not a tile multiple), a query
    shard (T != S) at a `row_offset`, head_dim 64, the 7B grouping (G=7, not a
    divisor of the 128-row tile), a non-causal call and a peaked softmax (q
    and k at 2x, so that rows do not average thousands of keys): each row
    that sees a key within one rounding step (bf16) or 1e-5 (fp32) of its own
    largest output, every row finite, the rows that see no key zero on both
    sides; bf16 at both CTA heights (64 and 128 query rows)."""
    from vibevoice_tpu_torch.ops import flash_attention as fa
    b, t, s, h, kvh, d, pad, off, dt, causal, sc = FLASH_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=cuda_device)
    q, k, v = (sc * rnd(b, t, h, d)).to(dt), (sc * rnd(b, s, kvh, d)).to(dt), \
        (0.5 * rnd(b, s, kvh, d)).to(dt)
    mask = torch.ones((b, s), dtype=torch.int32, device=cuda_device)
    mask[b - 1, :pad] = 0
    before = fa.flash_attention_prefill.launches
    runs = [fa.flash_attention_prefill(q, k, v, mask, causal=causal, row_offset=off)]
    runs += [fa.flash_attention_prefill_at(q, k, v, mask, rows, causal=causal, row_offset=off)
             for rows in ((64, 128) if dt == torch.bfloat16 else ())]
    torch.cuda.synchronize()
    want = fa.flash_attention_prefill_ref(q, k, v, mask, causal=causal, row_offset=off)
    assert fa.flash_attention_prefill.launches == before + len(runs)
    real = mask[:, (off or 0) + torch.arange(t, device=cuda_device)] > 0
    if not causal:  # every row sees every real key
        real = torch.ones_like(real)
    w = want[real].float()
    tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * w.abs().amax(dim=-1, keepdim=True)
    for got in runs:
        assert torch.isfinite(got).all()
        err = (got[real].float() - w).abs()
        assert bool((err <= tol).all()), float((err / tol).max())
        assert not got[~real].any()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_prefill(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   v[..., :32].contiguous(), mask)


# the plain chain's cases (B, T, D, blocks): the step's four stages are two
# shapes (decoder 0 / encoder 6: D=2048, 8 blocks, T=1; decoder 1 / encoder 5:
# D=1024, 3 blocks, T=8), at B=1, 2 and 4, and a tiny ragged one
PLAIN_CHAIN_CASES = [(1, 1, 2048, 8), (2, 1, 2048, 8), (4, 1, 2048, 8), (1, 8, 1024, 3),
                     (2, 8, 1024, 3), (4, 8, 1024, 3), (3, 5, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d,n", PLAIN_CHAIN_CASES)
def test_plain_chain_kernel_matches_plain(cuda_device, dtype, b, t, d, n):
    """The plain-pack chain at the 1.5B stage shapes at B=1, 2 and 4 and a
    tiny ragged one, bf16 and fp32 packs, over two chunks with the context
    carried."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    pack = fb.pack_stage(_stage(d, n, gen, cuda_device), dtype=dtype)
    got_c = want_c = (0.5 * torch.randn((b, n, 6, d), generator=gen, device=cuda_device)).to(dtype)
    for _ in range(2):
        x = (0.5 * torch.randn((b, t, d), generator=gen, device=cuda_device)).to(dtype)
        before = fb.fused_block_chain_plain.launches
        y, got_c = fb.fused_block_chain_plain(pack, x, got_c)
        torch.cuda.synchronize()
        y_ref, want_c = fb.fused_block_chain_plain_ref(pack, x, want_c)
        assert fb.fused_block_chain_plain.launches == before + 1
        for g, w in ((y, y_ref), (got_c, want_c)):
            assert g.dtype == dtype and torch.isfinite(g).all()
            # bf16: one rounding step of the largest value; fp32: sums in
            # another order through n blocks
            tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d,n", [(3, 5, 24, 2), (3, 5, 36, 2), (2, 3, 352, 2), (5, 8, 1024, 1),
                                     (1, 1, 4, 1), (1, 8, 6, 2), (2, 3, 3, 2)])
def test_plain_chain_ragged_shapes(cuda_device, dtype, b, t, d, n):
    """Widths that do not fill the card evenly: D=24 (ranks of a cluster
    without D columns), D=36 (bf16 rows that are not whole 16-byte vectors:
    cp.async into the rings), D=352 (F=1408 on 88 CTAs of 16 columns: the
    last cluster part idle), B=5 T=8 in three row groups, D=4, and D not a
    multiple of 4 (D=6, F=24 of `tiny_config(n_filters=3)`; D=3, F=12: the
    depth padded to 4 with zeros); bf16 and fp32, against the plain version
    at its stated tolerance."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    pack = fb.pack_stage(_stage(d, n, gen, cuda_device), dtype=dtype)
    x, ctx = (v.to(dtype) for v in _chain_inputs(b, t, d, n, gen, cuda_device))
    y, new_ctx = fb.fused_block_chain_plain(pack, x, ctx)
    torch.cuda.synchronize()
    y_ref, ctx_ref = fb.fused_block_chain_plain_ref(pack, x, ctx)
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    # bf16: one rounding step of the largest value; fp32: sums in another order
    scale = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for g, w in ((y, y_ref), (new_ctx, ctx_ref)):
        torch.testing.assert_close(g.float(), w.float(), atol=scale * float(w.float().abs().max()),
                                   rtol=0)


def _plain_chain_case(dev, b, t, d, n, seed=7):
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=dev).manual_seed(seed)
    pack = fb.pack_stage(_stage(d, n, gen, dev), dtype=torch.bfloat16)
    return (pack, *_chain_inputs(b, t, d, n, gen, dev))


@pytest.mark.parametrize("b,t,d,n", [(1, 1, 2048, 8), (1, 8, 1024, 3), (4, 8, 1024, 3)])
def test_plain_chain_is_one_deterministic_launch(cuda_device, b, t, d, n):
    """Every sum of the plain chain runs in a fixed order: two calls on the
    same inputs give the same bits, each one kernel on the device."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    pack, x, ctx = _plain_chain_case(cuda_device, b, t, d, n)
    first = fb.fused_block_chain_plain(pack, x, ctx)  # builds and loads the library
    second, kernels = _device_kernels(lambda: fb.fused_block_chain_plain(pack, x, ctx))
    assert len(kernels) == 1 and "chain_p_kernel" in kernels[0], kernels
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


def test_plain_chain_replays_in_a_cuda_graph(cuda_device):
    """The plain chain captured in a CUDA graph and replayed three times
    gives the eager call's bits: the grid barrier's counter and the cached
    workspace survive replay."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    pack, x, ctx = _plain_chain_case(cuda_device, 1, 8, 1024, 3)
    want = fb.fused_block_chain_plain(pack, x, ctx)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):  # the capture stream's workspace, made eagerly
        fb.fused_block_chain_plain(pack, x, ctx)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = fb.fused_block_chain_plain(pack, x, ctx)
    for _ in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_flash_prefill_and_plain_chain_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 model at head_dim 128 (hidden 512, 4 heads) with flash
    prefill forced on (B=2, one row left-padded) and the small-T chains on
    plain packs: both kernels on the card, the plain versions on the CPU;
    equal tokens, audio within 1e-3 of its scale."""
    from vibevoice_tpu_torch.ops import flash_attention as fa, fused_blocks as fb
    cfg = tiny_config(hidden_size=512, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, generator=gen, device="cpu")
    for name in ("acoustic_decoder", "semantic_encoder"):  # audio of order 0.1, not 1e-7
        for stage in params[name]["stages"]:
            for bp in stage:
                bp["gamma"] = bp["gamma"] * 0.5e6
                bp["ffn_gamma"] = bp["ffn_gamma"] * 0.5e6
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for name in ("final_ada_w", "final_linear"):
        head[name] = torch.randn(head[name].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)
    rng = np.random.default_rng(0)
    b, t, steps = 2, 40, 10
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True,
                              max_length_times=64.0)
    counters = (fa.flash_attention_prefill, fb.fused_block_chain_plain)
    runs = {}
    for name, where in (("cpu", "cpu"), ("card", cuda_device)):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_prefill=True, use_fused_chains=True,
                       device=where)
        before = [c.launches for c in counters]
        res = G.generate(eng, ids, mask, sim, latent_noise=noise)
        runs[name] = (res, [c.launches - n for c, n in zip(counters, before)])
    (ref, cpu_launches), (got, card_launches) = runs["cpu"], runs["card"]
    assert cpu_launches == [0, 0]
    # flash once per layer in the prefill; 3 + 3 chain stages per diffusing
    # step, through the wrapper in the prefill, the warm-up step and the
    # captured one
    assert card_launches == [cfg.decoder.num_hidden_layers, 3 * 6]
    nodes = _graph_nodes(eng)
    assert (nodes["flash_attention_prefill"], nodes["fused_block_chain"]) == (0, 6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    assert np.isfinite(a).all() and np.abs(w).max() > 0
    np.testing.assert_allclose(a, w, atol=1e-3 * np.abs(w).max(), rtol=0)


# ---------------------------------------------------------------------------
# the compiled decode step: captured once per engine, replayed by decode_chunk
# ---------------------------------------------------------------------------

GRAPH_CASES = ("plain", "int4", "stages-b2", "plain-chain", "bf16-head")
GRAPH_STEPS, GRAPH_CHUNKS = 24, (4, 5)  # a warm-up step and 3 replays, then 5


def _graph_engines(case, dev, **gen_kw):
    """An eager engine and a graph engine (sharing the eager one's params and
    packs) on a tiny fp32 model (head_dim 64), B=2, injected x_T: decode
    attention alone (plain), the int4 modes (B2, B3, B8), the fused stages
    at B=2 (B4 and the row-lane B7), or the plain chains (B6); or the same
    model in bf16, whose 256-wide head takes the bf16 head kernel."""
    from chip_smoke import _live_audio_path
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    dtype = torch.bfloat16 if case == "bf16-head" else torch.float32
    params = V.init_model(cfg, dtype=dtype, generator=gen, device="cpu")
    _live_audio_path(params, gen)
    kw = dict(use_flash_decode=True, inject_latent_noise=not gen_kw, dtype=dtype)
    t = 40
    if case == "int4":
        params = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.float32,
                              device="cpu", quantize="int4", int4_group_size=32,
                              quantize_tokenizer="int4k", quantize_diffusion="int4k",
                              tokenizer_min_dim=4).params  # with its int4 chain packs
        t = 72  # a 144-row prompt: prefill takes the dequantized route
    elif case == "stages-b2":
        kw.update(use_fused_stages=True, fused_stage_t_min=7)
    elif case == "plain-chain":
        kw.update(use_fused_chains=True)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True,
                              max_length_times=64.0, **gen_kw)
    eager = G.Engine(params, cfg, gcfg, max_steps=GRAPH_STEPS, batch=2, prompt_len=t,
                     device=dev, eager=True, **kw)
    graph = G.Engine(eager.params, cfg, gcfg, max_steps=GRAPH_STEPS, batch=2, prompt_len=t,
                     device=dev, **kw)
    return eager, graph


def _graph_request(eng, seed):
    """One request: prefill and decode_chunk of GRAPH_CHUNKS steps.  Returns
    the stacked step outputs (the prefill's step 0 first), the final state's
    buffers (copies), and each call's launches by wrapper."""
    from chip_smoke import kernel_counters
    counters = kernel_counters()

    def snap():
        return {k: c.launches for k, c in counters.items()}

    rng = np.random.default_rng(seed)
    b, t = eng.batch, eng.prompt_len
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[b - 1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(GRAPH_STEPS, b, eng.cfg.acoustic_vae_dim)).astype(np.float32)
    calls = []
    before = snap()
    state, out = eng.prefill(ids, mask, sim, latent_noise=noise,
                             generator=torch.Generator(eng.device).manual_seed(seed))
    calls.append({k: v - before[k] for k, v in snap().items()})
    outs = [G.StepOutput(*(x[None] for x in out))]
    for n in GRAPH_CHUNKS:
        before = snap()
        state, o = eng.decode_chunk(state, n)
        calls.append({k: v - before[k] for k, v in snap().items()})
        outs.append(o)
    torch.cuda.synchronize()
    final = {k: getattr(state, k).clone() for k in ("tokens", "emitted", "audio", "frames",
                                                     "finished", "reach_max")}
    return G.StepOutput(*(torch.cat(x) for x in zip(*outs))), final, calls


_GRAPH_RUNS = {}


def _graph_runs(case, dev):
    """Two requests (seeds 0 and 1) on each engine of `case`, cached per case:
    {"eager"|"graph": [(outputs, final buffers, launches per call)] * 2},
    and the graph engine."""
    if case not in _GRAPH_RUNS:
        eager, graph = _graph_engines(case, dev)
        runs = {"eager": [_graph_request(eager, s) for s in (0, 1)], "graph": []}
        runs["graph"].append(_graph_request(graph, 0))
        first = graph.graph
        runs["graph"].append(_graph_request(graph, 1))
        assert graph.graph is first, "the second request captured the step again"
        _GRAPH_RUNS[case] = (runs, graph)
    return _GRAPH_RUNS[case]


def _assert_bit_equal(got, want):
    (go, gf, _), (wo, wf, _) = got, want
    for name, g, w in zip(G.StepOutput._fields, go, wo):
        assert torch.equal(g, w), (name, float((g.float() - w.float()).abs().max()))
    for k in wf:
        assert torch.equal(gf[k], wf[k]), k
    assert bool(wo.emitted.all()) and float(wf["audio"].abs().max()) > 0


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_step_matches_eager_step(cuda_device, case):
    """The captured step replayed 8 times (a warm-up step, then chunks of 4
    and 5 steps) gives the eager step's tokens, emitted and finished flags
    and audio, bit-equal: the same kernels on the same inputs."""
    runs, graph = _graph_runs(case, cuda_device)
    _assert_bit_equal(runs["graph"][0], runs["eager"][0])
    assert graph.capture_s is not None and graph.replays >= 8


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_nodes_equal_step_launches(cuda_device, case):
    """Each kernel's nodes in the captured step equal its launches in one
    eager step; through the wrappers the graph engine launches twice a
    step's count in its first chunk (the warm-up step and the capture) and
    nothing in the replays."""
    from chip_smoke import merge_stages
    runs, graph = _graph_runs(case, cuda_device)
    (_, _, eager_calls), (_, _, graph_calls) = runs["eager"][0], runs["graph"][0]
    per_step = {k: v // GRAPH_CHUNKS[0] for k, v in eager_calls[1].items()}
    assert eager_calls[1] == {k: GRAPH_CHUNKS[0] * v for k, v in per_step.items()}
    assert eager_calls[2] == {k: GRAPH_CHUNKS[1] * v for k, v in per_step.items()}
    assert graph_calls[0] == eager_calls[0]  # the prefill
    assert graph_calls[1] == {k: 2 * v for k, v in per_step.items()}
    assert not any(graph_calls[2].values())
    assert _graph_nodes(graph) == merge_stages(per_step)
    want = {"plain": "decode_attention", "int4": "fused_head_solver_step",
            "stages-b2": "fused_stage_chain_rowlane", "plain-chain": "fused_block_chain",
            "bf16-head": "fused_head_bf16"}
    assert per_step["decode_attention"] > 0 and per_step[want[case]] > 0


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_serves_a_second_request(cuda_device, case):
    """A second request on the same engine: its prefill writes into the
    graph's static buffers, no capture happens, and the replays match the
    eager engine's second request bit for bit."""
    runs, _ = _graph_runs(case, cuda_device)
    _assert_bit_equal(runs["graph"][1], runs["eager"][1])
    assert not any(v for call in runs["graph"][1][2][1:] for v in call.values())


def test_graph_draws_the_generators_noise(cuda_device):
    """sde-dpmsolver++ with x_T drawn from the request's generator (no
    injected noise): the graph's registered generator draws, replay by
    replay, the noise the eager step draws from the same seed, and a
    second request with the same seed draws it again."""
    eager, graph = _graph_engines("plain", cuda_device, algorithm_type="sde-dpmsolver++")
    want = _graph_request(eager, 0)
    _assert_bit_equal(_graph_request(graph, 0), want)
    _assert_bit_equal(_graph_request(graph, 0), want)
    assert not torch.equal(want[0].audio_chunk[1], want[0].audio_chunk[2])


def _all_nodes(graph) -> int:
    """Every node (kernel, copy, fill, event record) of a captured graph."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n)) == 0
    return n.value


def test_traced_graph_replays_bit_equal_with_its_parts_summing_to_the_replay(cuda_device):
    """A tracer set on the engine recaptures the step with its parts'
    boundary events: 7 more nodes (6 segments, "rest" being two), none once
    the tracer is taken off again; the traced and untraced requests are
    bit-equal; the parts of a replay sum, within 3%, to CUDA events recorded
    around `graph.replay()`; and each chunk reads the last replay of the one
    before as a part sample."""
    from vibevoice_tpu_torch.utils.profiling import PARTS, Tracer
    _, eng = _graph_engines("plain", cuda_device)
    want = _graph_request(eng, 0)
    plain_nodes = _all_nodes(eng.graph)
    tr = Tracer()
    eng.set_tracer(tr)
    _assert_bit_equal(_graph_request(eng, 0), want)
    assert _all_nodes(eng.graph) == plain_nodes + 7 and eng.captures == 2
    marks = eng._graph_marks
    assert [m[0] for m in marks] == [None, "lm", "rest", "head", "acoustic_decoder",
                                     "semantic_encoder", "rest"]
    # the second chunk read the first's last replay, or skipped it if not yet
    # done; the request ended in a synchronize, so the second's is done
    c = tr.counters
    assert c["part_samples"] + c["part_samples_skipped"] == 1 and c["chunks"] == 2
    samples = c["part_samples"]
    eng._read_replay(tr)
    assert c["part_samples"] == samples + 1 and set(tr.sampled_ns) == set(PARTS)
    ratios = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # the device busy while the host enqueues
        a.record()
        eng.graph.replay()
        b.record()
        b.synchronize()
        parts = sum(x[1].elapsed_time(y[1]) for x, y in zip(marks, marks[1:]))
        ratios.append(parts / a.elapsed_time(b))
    assert abs(float(np.median(ratios)) - 1) < 0.03, ratios
    eng.set_tracer(None)
    _assert_bit_equal(_graph_request(eng, 0), want)
    assert _all_nodes(eng.graph) == plain_nodes and eng._graph_marks is None


# ---------------------------------------------------------------------------
# the serving layer on the card: HTTP handler threads beside a worker thread
# that owns the card and captures each engine's step
# ---------------------------------------------------------------------------

def test_server_on_card_equals_generate_and_captures_on_the_worker(cuda_device):
    """A tiny fp32 model (head_dim 64: decode attention on the kernel, the
    fused stages at T >= 7, row-lane at B=2) served over HTTP at B=1 and in
    a batch of two: each response's PCM equals `tts.generate` on the card
    for the same batch and seed, called after the server stops, and each
    engine's step was captured once, on the server's worker thread."""
    import threading

    from chip_smoke import _live_audio_path, register_forced_engine, send_batch, uses_rowlane_any
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    from vibevoice_tpu_torch.serving.server import TTSServer, wav_bytes
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, generator=gen, device="cpu")
    _live_audio_path(params, gen)
    tts = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.float32,
                       device=cuda_device, ddpm_steps=3, use_fused_stages=True,
                       prompt_bucket=64)
    rng = np.random.default_rng(0)
    presets = {n: rng.normal(0, 0.05, 480).astype(np.float32) for n in ("a", "b")}
    scripts, steps = ["Speaker 1: one request alone.", "Speaker 1: the second of two."], 12
    engines = [register_forced_engine(tts, G, scripts[:1], [[presets["a"]]], steps,
                                      use_flash_decode=True, fused_stage_t_min=7),
               register_forced_engine(tts, G, scripts, [[presets["a"]], [presets["b"]]], steps,
                                      use_flash_decode=True, fused_stage_t_min=7)]
    assert uses_rowlane_any(engines[1])
    threads = {}
    for eng in engines:
        def capture(static, outs, eng=eng, real=eng._capture):
            threads[id(eng)] = threading.current_thread()
            return real(static, outs)
        eng._capture = capture
    srv = TTSServer(tts, port=0, max_batch=2, max_wait_ms=400, voice_presets=presets).start()
    body = lambda i, seed: ("/tts", dict(script=scripts[i], voice="ab"[i], seed=seed,
                                         max_new_tokens=steps))
    try:
        alone = send_batch(srv.port, [body(0, 5)])
        pair = send_batch(srv.port, [body(0, 7), body(1, 7)])
    finally:
        srv.stop()
    for r, want_b in ((alone[0], "1"), (pair[0], "2"), (pair[1], "2")):
        assert r["status"] == 200 and r["batch_size"] == want_b
    for eng in engines:
        assert eng.captures == 1 and eng.replays > 0
        assert threads[id(eng)] is not threading.main_thread()
    res, _ = tts.generate(scripts[:1], [[presets["a"]]], max_new_tokens=steps, seed=5)
    assert alone[0]["body"] == wav_bytes(res.audio[0])
    res, _ = tts.generate(scripts, [[presets["a"]], [presets["b"]]], max_new_tokens=steps,
                          seed=7)
    for i in range(2):
        assert pair[i]["body"] == wav_bytes(res.audio[i])
        assert np.any(np.frombuffer(pair[i]["body"][44:], "<i2"))


def test_train_step_on_card_matches_cpu(cuda_device):
    """Two train_steps of tiny_config(vocab_size=320) in fp32 on the card and
    on the CPU, from the same weights, batch and injected noise and
    timesteps, TF32 off: the losses and every parameter afterwards agree
    within chip_smoke.TRAIN_REL_TOL, and no kernel launches
    (`chip_smoke.phase_train_reference` raises otherwise)."""
    from chip_smoke import TRAIN_REL_TOL, phase_train_reference
    loss_err, param_err = phase_train_reference(cuda_device)
    assert loss_err <= TRAIN_REL_TOL and param_err <= TRAIN_REL_TOL


def test_train_step_launches_no_kernel(cuda_device):
    """A training step on the card at T=1024 with head_dim 64, where the
    engine would prefill through flash attention: no kernel wrapper's
    `launches` counter moves, the losses are finite and the weights move."""
    from chip_smoke import kernel_counters, tiny_train_batch
    from vibevoice_tpu_torch import train as T
    dev = cuda_device
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    params = V.init_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    batch = tiny_train_batch(cfg, pad_to_multiple=1024)
    assert batch.input_ids.shape == (2, 1024)
    opt = T.make_optimizer(params, lr=1e-3, warmup_steps=0, total_steps=10)
    step = T.make_train_step(cfg, opt, device=dev)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    embed = params["lm"]["embed"].detach().clone()
    metrics = step(params, batch, torch.Generator(device=dev).manual_seed(1))
    assert {k: c.launches for k, c in counters.items() if c.launches} == {}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert not torch.equal(params["lm"]["embed"], embed)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_tp_train_step_on_card_matches_cpu(cuda_device):
    """Two TP=2 train steps of tiny_config(vocab_size=320) with an untied
    `lm_head` (split by column, its logits gathered) as two gloo ranks, each
    on the card and on the CPU from the same shard, batch and injected noise:
    the losses and every leaf afterwards agree within
    chip_smoke.TRAIN_REL_TOL (`chip_smoke.phase_train_sharded_reference`
    raises otherwise)."""
    from chip_smoke import TRAIN_REL_TOL, phase_train_sharded_reference
    loss_err, param_err = phase_train_sharded_reference(cuda_device)
    assert loss_err <= TRAIN_REL_TOL and param_err <= TRAIN_REL_TOL


def _rank_mesh(rank):
    """Rank `rank` of a two-rank model axis, with no process group: enough for
    the sharded wrappers, which make no collective."""
    from vibevoice_tpu_torch.parallel.mesh import Mesh
    return Mesh(1, 2, rank=rank, groups={})


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_on_a_tp_shard(cuda_device, quant):
    """The 1.5B cache split over two TP ranks: each rank's decode attention
    reads its own 128 lanes (H=6, KVH=1, G=6) through
    `decode_attention_sharded`, one launch, and agrees with the plain version
    on the shard and with the query heads' slice of the whole cache's kernel
    output (bf16 rounding, fp32 sums in another split order)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(11)
    s = 4096
    q = torch.randn((2, 12, 128), generator=gen, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(28, 2, s, 256, quant, gen, dev)
    lengths = torch.tensor([1500, s], dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    vis[1, 1:40] = 0
    assert da.plan(2, 1, s, torch.bfloat16, torch.cuda.get_device_properties(dev)
                   .multi_processor_count, k.dtype) >= 1
    for layer in (0, 27):
        full = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        for r in range(2):
            qr = q[:, 6 * r:6 * r + 6].contiguous()
            kr = k[..., 128 * r:128 * (r + 1)].contiguous()
            vr = v[..., 128 * r:128 * (r + 1)].contiguous()
            before = da.decode_attention.launches
            got = da.decode_attention_sharded(_rank_mesh(r), qr, kr, vr, layer, vis, lengths,
                                              ks, vs, num_key_value_heads=2)
            torch.cuda.synchronize()
            assert da.decode_attention.launches == before + 1
            want = da.decode_attention_ref(qr, kr, vr, layer, vis, lengths, ks, vs)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=0)
            torch.testing.assert_close(got.float(), full[:, 6 * r:6 * r + 6].float(),
                                       atol=2e-3, rtol=0)


def test_flash_prefill_on_a_tp_shard(cuda_device):
    """A 1024-token 1.5B prompt's attention split over two TP ranks: each
    rank's flash prefill on its heads (H=6, KVH=1, D=128) through
    `flash_attention_prefill_sharded`, one launch, within one bf16 rounding
    step of each row's largest output of the plain version on the shard and
    of the heads' slice of the whole prompt's kernel output."""
    from vibevoice_tpu_torch.ops import flash_attention as fa
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(12)
    rnd = lambda *shape: 0.5 * torch.randn(shape, generator=gen, device=dev)
    q, k, v = (rnd(1, 1024, 12, 128).to(torch.bfloat16), rnd(1, 1024, 2, 128).to(torch.bfloat16),
               rnd(1, 1024, 2, 128).to(torch.bfloat16))
    mask = torch.ones((1, 1024), dtype=torch.int32, device=dev)
    full = fa.flash_attention_prefill(q, k, v, mask)
    for r in range(2):
        qr = q[:, :, 6 * r:6 * r + 6].contiguous()
        kr, vr = k[:, :, r:r + 1].contiguous(), v[:, :, r:r + 1].contiguous()
        before = fa.flash_attention_prefill.launches
        got = fa.flash_attention_prefill_sharded(_rank_mesh(r), qr, kr, vr, mask,
                                                 num_key_value_heads=2)
        torch.cuda.synchronize()
        assert fa.flash_attention_prefill.launches == before + 1
        for want in (fa.flash_attention_prefill_ref(qr, kr, vr, mask),
                     full[:, :, 6 * r:6 * r + 6]):
            w = want.float()
            tol = 2 ** -7 * w.abs().amax(dim=-1, keepdim=True)
            assert bool(((got.float() - w).abs() <= tol).all())
    with pytest.raises(ValueError, match="num_key_value_heads"):
        fa.flash_attention_prefill_sharded(_rank_mesh(0), q, k, v, mask, num_key_value_heads=2)


def _tiny_train(drawn):
    """tiny_config(vocab_size=320) in fp32 with its scaling statistics set, a
    function that makes its seeded weights on the card, and the tiny batch.  With
    injected noise the acoustic VAE samples at fix_std 0 (the draws of a
    step without a generator do not reach the latents)."""
    import dataclasses
    from chip_smoke import tiny_train_batch
    cfg = tiny_config(vocab_size=320)
    if not drawn:
        cfg = dataclasses.replace(cfg, acoustic_tokenizer=dataclasses.replace(
            cfg.acoustic_tokenizer, fix_std=0.0))
    dev = G.resolve_device("cuda")

    def make_params():
        p = V.init_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        p["speech_scaling_factor"] = torch.tensor(0.8, device=dev)
        p["speech_bias_factor"] = torch.tensor(0.1, device=dev)
        return p
    return cfg, make_params, tiny_train_batch(cfg)


@pytest.mark.parametrize("noise", ["injected", "drawn"])
def test_captured_train_step_bit_equal_to_eager(cuda_device, noise):
    """Three train steps of the tiny model captured (the default on the card:
    a warm-up step, the capture, two replays) and three eager ones, from one
    set of weights, one batch and one generator seed (or injected noise):
    the losses of every step and every parameter afterwards are bit-equal."""
    from chip_smoke import bit_equal_runs, train_eager_vs_graph
    cfg, make_params, batch = _tiny_train(noise == "drawn")
    runs = train_eager_vs_graph(cfg, make_params, batch, cuda_device, 3, noise == "injected",
                                lr=1e-2)
    graph = runs["graph"]
    assert graph["captures"] == 1 and graph["replays"] == 2 and runs["eager"]["captures"] == 0
    got = bit_equal_runs(runs)
    assert got["losses_equal"] and got["leaves_differ"] == 0, got
    assert np.isfinite(np.asarray(got["losses_graph"])).all()


def test_captured_train_step_one_graph_per_batch_shape(cuda_device):
    """A repeated batch shape replays its graph; a new shape (another
    padding) captures a second one in the same memory pool; going back to
    the first shape replays the first graph, and the losses stay finite."""
    from chip_smoke import tiny_train_batch
    from vibevoice_tpu_torch import train as T
    cfg, make_params, batch = _tiny_train(True)
    wide = tiny_train_batch(cfg, pad_to_multiple=128)
    assert wide.input_ids.shape != batch.input_ids.shape
    params = make_params()
    opt = T.make_optimizer(params, lr=1e-3, warmup_steps=1, total_steps=10)
    step = T.make_train_step(cfg, opt, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    losses = [float(step(params, b, gen)["loss"]) for b in (batch, batch, wide, batch, wide)]
    assert step.captures == 2 and len(step.graphs) == 2 and step.replays == 3
    assert step.pool is not None and opt.count == 5
    assert all(np.isfinite(losses))


def test_captured_train_step_returns_its_own_metrics(cuda_device):
    """The metrics a replay returns are copies: the next replay does not
    overwrite them."""
    from vibevoice_tpu_torch import train as T
    cfg, make_params, batch = _tiny_train(True)
    params = make_params()
    opt = T.make_optimizer(params, lr=1e-2, warmup_steps=1, total_steps=10)
    step = T.make_train_step(cfg, opt, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    step(params, batch, gen)
    first = step(params, batch, gen)
    kept = {k: v.clone() for k, v in first.items()}
    second = step(params, batch, gen)
    assert step.replays == 2
    assert all(torch.equal(first[k], kept[k]) for k in kept)
    assert not torch.equal(first["loss"], second["loss"])


def test_train_step_on_a_mesh_needs_eager(cuda_device):
    """A train step on a mesh whose model axis of 2 has no process group is
    not captured: without `eager=True` it raises, with it the step is
    made."""
    from vibevoice_tpu_torch import train as T
    cfg = tiny_config(vocab_size=320)
    opt = T.make_optimizer({"w": torch.zeros(2, 2, device=cuda_device)})
    with pytest.raises(ValueError, match="eager=True"):
        T.make_train_step(cfg, opt, device=cuda_device, mesh=_rank_mesh(0))
    assert not T.make_train_step(cfg, opt, device=cuda_device, mesh=_rank_mesh(0),
                                 eager=True).use_graph


def _one_rank_group(backend, tmp_path):
    """A default process group of one rank (`backend`) in this process; the
    caller destroys it."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)


def test_captured_sharded_step_over_nccl_bit_equal_to_eager(cuda_device, tmp_path):
    """On a (1, 1) mesh over an NCCL group of one rank, as both its data and
    its model group (`chip_smoke.one_rank_nccl_mesh`: every collective of the
    sharded step is issued), three captured train steps of the tiny model
    and three eager ones from one set of weights, batch and injected noise
    are bit-equal (losses, every leaf); the step issues its all-reduces over
    both groups; both turns are within chip_smoke.TRAIN_REL_TOL of the
    unsharded captured step (its clip sums the leaves' squares in another
    order)."""
    import torch.distributed as dist
    from chip_smoke import TRAIN_REL_TOL, compare_mesh_turns, one_rank_nccl_mesh
    from chip_smoke import mesh_train_turns, shard_injected
    cfg, make_params, batch = _tiny_train(False)
    _one_rank_group("nccl", tmp_path)
    try:
        mesh = one_rank_nccl_mesh()
        assert mesh.backend("data") == mesh.backend("model") == "nccl"
        runs = mesh_train_turns(cfg, make_params, batch, shard_injected(batch, cfg, 3),
                                cuda_device, mesh, lr=1e-2)
    finally:
        dist.destroy_process_group()
    got = compare_mesh_turns(runs)
    assert got["losses_equal"] and got["leaves_differ"] == 0, got
    graph = runs["graph"]
    assert graph["captures"] == 1 and graph["replays"] == 2 and len(graph["nodes"]) == 1
    assert runs["eager"]["captures"] == 0
    assert runs["eager"]["collectives"].get("all_reduce", 0) > 0
    for turn in ("graph", "eager"):
        assert got[turn + "_vs_unsharded"]["loss_max_rel_err"] <= TRAIN_REL_TOL, got
    assert np.isfinite(torch.stack(graph["losses"]).numpy()).all()


def test_train_step_on_a_gloo_mesh_needs_eager(cuda_device, tmp_path):
    """A mesh over gloo cannot capture its step on the card: without
    `eager=True` `make_train_step` raises, with it the step is made."""
    import torch.distributed as dist
    from vibevoice_tpu_torch import train as T
    from vibevoice_tpu_torch.parallel.mesh import Mesh
    cfg = tiny_config(vocab_size=320)
    opt = T.make_optimizer({"w": torch.zeros(2, 2, device=cuda_device)})
    _one_rank_group("gloo", tmp_path)
    try:
        g = dist.group.WORLD
        mesh = Mesh(1, 1, rank=0, groups={"data": g, "model": g})
        with pytest.raises(ValueError, match="eager=True"):
            T.make_train_step(cfg, opt, device=cuda_device, mesh=mesh)
        assert not T.make_train_step(cfg, opt, device=cuda_device, mesh=mesh,
                                     eager=True).use_graph
    finally:
        dist.destroy_process_group()
