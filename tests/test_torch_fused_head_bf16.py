"""The port's bf16 diffusion-head kernel (`ops/fused_head_bf16.py`) on the CPU:
its plain version against `diffusion_head.apply_with_modulations` in float32,
the route an engine takes (only plain bf16 CUDA weights without a TP mesh or
an int4 pack), `sample_speech_latents` on the route (the benchmark's tap still
sees `precompute_modulations` and `dpm_solver.step`), the tracer's
"head.bf16k_steps" count, and the launch plan.  The kernel itself runs on the
card (`tests/test_torch_cuda.py`)."""
import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.configs import DiffusionHeadConfig, tiny_config
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import diffusion_head as DH, vibevoice as V
from vibevoice_tpu_torch.ops import fused_head as FH, fused_head_bf16 as FHB
from vibevoice_tpu_torch.schedule import dpm_solver as DS
from vibevoice_tpu_torch.utils.profiling import Tracer
from vibevoice_tpu_torch.utils.quantize import quantize_diffusion_head

CUDA = torch.device("cuda")


def _head(h, f, lat=16, layers=3, seed=0, dtype=torch.float32):
    """A head at width h, FFN width f, with live (non-zero) adaLN and final
    layers, in `dtype`."""
    cfg = DiffusionHeadConfig(hidden_size=h, latent_size=lat, head_layers=layers,
                              head_ffn_ratio=f / h)
    gen = torch.Generator().manual_seed(seed)
    head = DH.init(cfg, device="cpu", generator=gen)
    r = lambda *s: torch.randn(s, generator=gen)
    for lp in head["layers"]:
        lp["ada_w"] = 0.05 * r(h, 3 * h)
        lp["norm_w"] = 1 + 0.1 * r(h)
    head["final_ada_w"], head["final_linear"] = 0.05 * r(h, 2 * h), 0.05 * r(h, lat)
    cast = lambda v: v.to(dtype) if isinstance(v, torch.Tensor) else v
    head = {k: ([{kk: cast(vv) for kk, vv in lp.items()} for lp in v] if k == "layers"
                else cast(v)) for k, v in head.items()}
    return cfg, head


@pytest.mark.parametrize("h,f", [(128, 384), (256, 640)])
@pytest.mark.parametrize("n", [2, 8, 16, 20])
def test_plain_version_equals_apply_with_modulations(n, h, f):
    """In float32 the op's plain version is the plain head step: the same
    float32 operations in the same order, so the same bits."""
    cfg, head = _head(h, f, seed=n)
    gen = torch.Generator().manual_seed(100 + n)
    noisy = torch.randn((n, cfg.latent_size), generator=gen)
    cond = torch.randn((n, h), generator=gen)
    mods, fmod = DH.precompute_modulations(head, cfg, cond, torch.tensor([999.0, 599.0, 99.0]))
    for i in range(3):
        want = DH.apply_with_modulations(head, cfg, noisy, [m[i] for m in mods], fmod[i])
        before = FHB.fused_head_bf16_step.launches
        got = FHB.fused_head_bf16_step(FHB.pack(head), noisy @ head["noisy_proj"],
                                       torch.stack([m[i] for m in mods]), fmod[i],
                                       head["final_linear"], cfg.rms_norm_eps)
        assert FHB.fused_head_bf16_step.launches == before  # the CPU launches nothing
        assert got.dtype == torch.float32 and torch.equal(got, want)


def _route_case(case):
    """(head, mesh, packq) of one route case, at a width the kernel takes."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    _, head = _head(128, 384, dtype=dtype)
    mesh, packq = None, None
    if case == "int8":
        head = quantize_diffusion_head(head, "int8")
    elif case == "int4k":
        packq = FH.pack_head_solver_q(_head(128, 384)[1])
    elif case == "tp":
        mesh = object()  # a model axis above 1: the engine's tp_mesh
    return head, mesh, packq


@pytest.mark.parametrize("case,device,want", [
    ("bf16", CUDA, True), ("int4k", CUDA, False), ("int8", CUDA, False),
    ("float32", CUDA, False), ("tp", CUDA, False), ("bf16", torch.device("cpu"), False)])
def test_route_takes_only_plain_bf16_cuda_weights(case, device, want):
    """The kernel only for plain bf16 weights on a CUDA device without a TP
    mesh or an int4k pack; the int4k head keeps B8, int8 and float32 heads and
    TP engines keep the plain path."""
    head, mesh, packq = _route_case(case)
    assert FHB.takes(head, device, mesh, packq) is want


def test_route_refuses_widths_the_kernel_does_not_take():
    for h, f in ((64, 192), (128, 100), (4224, 12672)):
        _, head = _head(h, f, dtype=torch.bfloat16)
        assert not FHB.takes(head, CUDA)


def test_route_takes_weights_inside_a_buffer_with_room_after_them():
    """Where a weight lies in memory does not choose the route: views that
    start inside a 16-byte unit (the benchmark's weights are views into one
    buffer), with or without room after them, and a layer's gate and up at
    different offsets into a unit all take it.  The wrapper raises for a
    weight the kernel cannot read (one that is not contiguous) rather than
    leaving the route, and for a layer whose gate and up start at different
    offsets into a unit (the kernel tiles both alike)."""
    _, head = _head(128, 384, dtype=torch.bfloat16)
    w = head["layers"][1]["up"]
    view = torch.zeros(w.numel() + 9, dtype=torch.bfloat16)[1:1 + w.numel()].view(w.shape)
    tight = torch.zeros(w.numel() + 3, dtype=torch.bfloat16)[3:].view(w.shape)
    nw = torch.zeros(129, dtype=torch.bfloat16)[1:]
    for gate, up, norm in ((view, view, nw), (tight, tight, nw), (view, tight, nw)):
        moved = dict(head, layers=[dict(lp, gate=gate, up=up, norm_w=norm)
                                   for lp in head["layers"]])
        assert FHB.takes(moved, CUDA)
    transposed = dict(head, layers=[dict(lp, down=lp["down"].t().contiguous().t())
                                    for lp in head["layers"]])
    assert FHB.takes(transposed, CUDA)
    pk, n = FHB.pack(transposed), 2
    args = (torch.zeros(n, 128, dtype=torch.bfloat16),
            torch.zeros(len(pk["gate"]), n, 3 * 128, dtype=torch.bfloat16),
            torch.zeros(n, 2 * 128, dtype=torch.bfloat16), transposed["final_linear"])
    with pytest.raises(ValueError, match="contiguous weights"):
        FHB._check(pk, *args)
    FHB._check(FHB.pack(head), *args)
    FHB._check(FHB.pack(dict(head, layers=[dict(lp, gate=tight, up=tight)
                                           for lp in head["layers"]])), *args)
    with pytest.raises(ValueError, match="same offset"):
        FHB._check(FHB.pack(dict(head, layers=[dict(lp, gate=view, up=tight)
                                               for lp in head["layers"]])), *args)


def test_pack_holds_the_heads_own_tensors():
    _, head = _head(128, 384, dtype=torch.bfloat16)
    pk = FHB.pack(head)
    for k in ("gate", "up", "down", "norm_w"):
        assert all(t is lp[k] for t, lp in zip(pk[k], head["layers"]))
    assert FHB.weight_bytes(pk) == 3 * 3 * 128 * 384 * 2


def _tiny_engine_params(dtype):
    cfg = tiny_config(hidden_size=128, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, dtype=dtype, generator=gen, device="cpu")
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = (0.05 * torch.randn(lp["ada_w"].shape, generator=gen)).to(dtype)
    for name in ("final_ada_w", "final_linear"):
        head[name] = (0.05 * torch.randn(head[name].shape, generator=gen)).to(dtype)
    return cfg, params


def test_engine_sets_the_route_only_where_it_fits(monkeypatch):
    """The engine's pack step sets `_diffusion_head_bf16` as `takes` says:
    never on the CPU, and dropped when it does not fit even if the tree
    brought one."""
    cfg, params = _tiny_engine_params(torch.bfloat16)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True)
    kw = dict(max_steps=4, batch=1, prompt_len=8, dtype=torch.bfloat16, device="cpu")
    eng = G.Engine(dict(params, _diffusion_head_bf16=FHB.pack(params["diffusion_head"])),
                   cfg, gcfg, **kw)
    assert "_diffusion_head_bf16" not in eng.params
    seen = []
    monkeypatch.setattr(FHB, "takes", lambda *a: seen.append(a) or True)
    eng = G.Engine(params, cfg, gcfg, **kw)
    pk = eng.params["_diffusion_head_bf16"]
    assert all(t is lp["gate"] for t, lp in
               zip(pk["gate"], eng.params["diffusion_head"]["layers"]))
    (head, device, mesh, packq), = seen
    assert device.type == "cpu" and mesh is None and packq is None
    assert "_diffusion_head_bf16" not in params  # the caller's tree is left as it was


def test_sample_speech_latents_on_the_route_keeps_the_taps_calls(monkeypatch):
    """With the route in the tree each solver step goes through
    `fused_head_bf16_step` (on the CPU its plain version): the latents are the
    plain path's within bf16 rounding, and `precompute_modulations` and
    `dpm_solver.step` are still called by name (the benchmark's tap), with
    the sample as step's 6th positional argument."""
    cfg, params = _tiny_engine_params(torch.bfloat16)
    dh = cfg.diffusion_head
    scfg = DS.SolverConfig(num_train_timesteps=dh.ddpm_num_steps,
                           beta_schedule=dh.ddpm_beta_schedule,
                           prediction_type=dh.prediction_type, algorithm_type="dpmsolver++")
    sched = DS.set_timesteps(scfg, DS.make_tables(scfg), 4)
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.bfloat16)
    cond, neg, x0 = t(2, 128), t(2, 128), t(2, cfg.acoustic_vae_dim)
    want = V.sample_speech_latents(params, cfg, scfg, sched, cond, neg, 1.3, x0)
    calls = {"mods": 0, "step": [], "kernel": 0}
    real_mods, real_step, real_k = DH.precompute_modulations, DS.step, FHB.fused_head_bf16_step

    def mods(*a, **k):
        calls["mods"] += 1
        return real_mods(*a, **k)

    def step(*a, **k):
        calls["step"].append(a[5])
        return real_step(*a, **k)

    def kernel(*a, **k):
        calls["kernel"] += 1
        return real_k(*a, **k)

    monkeypatch.setattr(DH, "precompute_modulations", mods)
    monkeypatch.setattr(DS, "step", step)
    monkeypatch.setattr(FHB, "fused_head_bf16_step", kernel)
    routed = dict(params, _diffusion_head_bf16=FHB.pack(params["diffusion_head"]))
    got = V.sample_speech_latents(routed, cfg, scfg, sched, cond, neg, 1.3, x0)
    assert calls["mods"] == 1 and calls["kernel"] == 4 and len(calls["step"]) == 4
    assert calls["step"][0] is x0
    # the route keeps x in fp32 across the layers where the plain path rounds
    # each op to bf16: a few bf16 steps of the latent's scale
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=4 * 2 ** -8 * scale, rtol=0)


def test_tracer_counts_the_kernels_solver_steps(monkeypatch):
    """head.bf16k_steps: `ddpm_steps` solver steps for the prefill's step 0
    and for every step of a decode chunk, counted from the engine's own
    state; an engine off the route counts nothing."""
    cfg, params = _tiny_engine_params(torch.bfloat16)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True)
    kw = dict(max_steps=8, batch=1, prompt_len=8, dtype=torch.bfloat16, device="cpu")
    ids, mask = np.full((1, 8), 7, np.int64), np.ones((1, 8), np.int32)
    sim = np.zeros((1, 8), bool)
    for routed in (False, True):
        if routed:  # on the CPU the route's calls take the plain version
            monkeypatch.setattr(FHB, "takes", lambda *a: True)
        eng = G.Engine(params, cfg, gcfg, **kw)
        assert ("_diffusion_head_bf16" in eng.params) is routed
        tr = Tracer()
        eng.set_tracer(tr)
        state = eng.prefill(ids, mask, sim)[0]
        eng.decode_chunk(state, 3)
        want = (1 + 3) * 3 if routed else 0
        assert tr.counters.get("head.bf16k_steps", 0) == want


_SHAPES = [(1536, 4608), (3584, 10752), (128, 384), (512, 1536), (4096, 12288)]


@pytest.mark.parametrize("clusters", [8, 15, 16])
@pytest.mark.parametrize("n", [2, 8, 16, 40])
@pytest.mark.parametrize("h,f", _SHAPES)
def test_head_plan_invariants(h, f, n, clusters):
    p = FHB.head_plan(n, h, f, 64, 132, clusters)
    assert p.tf % 8 == 0 and p.tf <= 256
    assert (p.tiles - 1) * p.tf < f + 8 <= p.tiles * p.tf  # the maps' columns
    assert p.clusters == -(-p.tiles // 8) <= clusters
    assert p.rows == (16 if n > 8 else 8) and p.nrc == -(-p.rows // p.clusters)
    assert h % p.ku == 0 and p.ku % 16 == 0 and (8 * p.tf) % p.kd == 0 and p.kd % 16 == 0
    assert p.stage_bytes % 1024 == 0 and p.stages >= 2
    assert p.stage_bytes >= 8 * 64 * 2  # a chunk of final_linear holds 8 rows or more
    assert p.stage_bytes >= 2 * (-(-p.ku * p.tf * 2 // 128) * 128)
    # down boxes cover a rank's H/8 columns and the 8 past them, in rows of
    # an odd number of 16-byte units
    assert p.wb % 16 == 8 and p.wb <= 256 and p.nbd * p.wb >= h // 8 + 8
    assert p.stage_bytes >= p.nbd * (-(-p.kd * p.wb * 2 // 128) * 128)
    assert p.smem == FHB.head_smem(h, p.tf, p.rows, 64, p.nrc, p.stages,
                                   p.stage_bytes) <= 227 * 1024


def test_head_plan_at_the_h100_shapes():
    """132 SMs, 16 clusters: 116 CTAs of 40 columns (1.5B), 123 of 88 (Large),
    three or more stages; widths the kernel does not take are refused."""
    p = FHB.head_plan(16, 1536, 4608, 64, 132, 16)
    assert (p.tf, p.tiles, p.clusters, p.rows) == (40, 116, 15, 16) and p.stages >= 3
    p = FHB.head_plan(16, 3584, 10752, 64, 132, 16)
    assert (p.tf, p.tiles, p.clusters, p.rows) == (88, 123, 16, 16) and p.stages >= 3
    for h, f in ((64, 192), (1536, 4604), (4224, 12672)):
        with pytest.raises(ValueError, match="multiples"):
            FHB.head_plan(16, h, f, 64, 132, 16)
