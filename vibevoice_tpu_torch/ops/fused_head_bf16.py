"""Fused bf16 diffusion-head solver step: CUDA kernel and plain version.

The adaLN head (ref modular_vibevoice_diffusion_head.py:191-280) runs once per
solver step, `ddpm_steps` times per frame, and each run re-reads every
layer's gate/up/down weights.  In bf16 the JAX package leaves it to XLA, and
the port's plain path (`models/diffusion_head.apply_with_modulations`) is ~85
cuBLAS and elementwise nodes a solver step.  `fused_head_bf16_step` runs one
step as ONE cluster launch of `csrc/fused_head_bf16.cu` (design and bound are
described there; `head_plan` sizes it, `fused_blocks.workspace` holds its
cached partials and barrier counter).  It replaces no TPU kernel.

The engine takes this route (`takes`) from its configuration alone: the
head's weights are plain bf16 tensors on a CUDA device, with no
tensor-parallel mesh and no int4 pack, at widths the kernel takes.  `pack`
holds the layers' own tensors (no copy), and the library caches a tensor map
per tensor; a weight may start anywhere in its memory, and a head the kernel
cannot read (a weight not contiguous, or a layer's gate and up at different
offsets into a 16-byte unit) raises.  CPU tensors take
`fused_head_bf16_step_ref`, the plain version with the same signature, which
is also the kernel's oracle.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_blocks import workspace

CLUSTER = 8        # CTAs per cluster: the portable size
_WARPS = 8         # consumer warps per CTA (warp 8 issues the copies)
_MAX_LAYERS = 8    # tensor maps the launch carries: three a layer
_MAX_HQ = 512      # columns of x a rank owns, at most
_SMEM_MAX = 227 * 1024
_LAYER_KEYS = ("gate", "up", "down", "norm_w")
_MAPPED = ("gate", "up", "down")  # read through tensor maps (norm_w by plain loads)


def takes(head_params: Dict[str, Any], device: torch.device, mesh=None, packq=None) -> bool:
    """Whether an engine on `device` runs its bf16 head on the kernel, from
    its configuration alone: the layers' gate/up/down and norm_w and
    final_linear are plain bf16 tensors, the device is CUDA, there is no
    tensor-parallel mesh (whose split FFN sums over the model group) and no
    int4 pack (which takes the int4 kernel), and the widths are ones the
    kernel takes (H a multiple of 128 up to 4096, F and the latent multiples
    of 8, at most 8 layers).  Where the weights lie in memory does not
    count: the kernel reads them wherever they start, and raises for a head
    it cannot read (`_check`)."""
    if torch.device(device).type != "cuda" or mesh is not None or packq is not None:
        return False
    layers = head_params["layers"]
    tensors = ([lp.get(k) for lp in layers for k in _LAYER_KEYS]
               + [head_params["final_linear"]])
    if not layers or len(layers) > _MAX_LAYERS or not all(
            isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 for t in tensors):
        return False
    h, f = layers[0]["gate"].shape
    lat = head_params["final_linear"].shape[1]
    return h % 128 == 0 and h // CLUSTER <= _MAX_HQ and f % 8 == 0 and lat % 8 == 0


def pack(head_params: Dict[str, Any]) -> Dict[str, List[torch.Tensor]]:
    """The layers' own gate, up, down and norm_w tensors, by name (no copy)."""
    return {k: [lp[k] for lp in head_params["layers"]] for k in _LAYER_KEYS}


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)


def fused_head_bf16_step_ref(pk, x: torch.Tensor, layer_mods: torch.Tensor,
                             final_mod: torch.Tensor, final_linear: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Plain PyTorch solver step: x [N, H] (after noisy_proj), layer_mods
    [L, N, 3H] (shift | scale | gate), final_mod [N, 2H], final_linear
    [H, latent] -> v-prediction [N, latent] in x's dtype.  The kernel's
    arithmetic: x in fp32 across the layers, h and the activations rounded to
    x's dtype where they enter the tensor cores, the weights in fp32 (exact
    for bf16 weights).  In float32 it is `diffusion_head.apply_with_modulations`."""
    dt, h = x.dtype, x.shape[1]
    xs = x.float()
    for i, (wg, wu, wd, nw) in enumerate(zip(*(pk[k] for k in _LAYER_KEYS))):
        mods = layer_mods[i].float()
        shift, scale, gate = mods[:, :h], mods[:, h:2 * h], mods[:, 2 * h:]
        hn = ((_rms(xs, eps) * nw.float()) * (1 + scale) + shift).to(dt).float()
        a = (F.silu(hn @ wg.float()) * (hn @ wu.float())).to(dt).float()
        xs = xs + gate * (a @ wd.float())
    fm = final_mod.float()
    xn = _rms(xs, eps) * (1 + fm[:, h:]) + fm[:, :h]
    return (xn @ final_linear.float()).to(dt)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _gu_bytes(ku: int, tf: int) -> int:
    """A gate/up ring chunk: two boxes of ku rows of tf bf16 columns."""
    return 2 * _up(ku * tf * 2, 128)


def _wd_boxes(h: int):
    """(wb, nbd): a down chunk's boxes cover a rank's H/8 + 8 columns in nbd
    boxes of wb columns, wb an odd multiple of 8 (so the eight rows an
    ldmatrix reads fall in distinct banks), at most 248."""
    need = h // CLUSTER + 8
    nbd = -(-need // 248)
    units = -(-need // (8 * nbd))
    return 8 * (units | 1), nbd


def _wd_bytes(kd: int, h: int) -> int:
    """A down ring chunk: nbd boxes of kd rows of wb bf16 columns."""
    wb, nbd = _wd_boxes(h)
    return nbd * _up(kd * wb * 2, 128)


def head_smem(h: int, tf: int, rows: int, lat: int, nrc: int, stages: int,
              stage_bytes: int) -> int:
    """Shared memory of one CTA (`layout` in csrc/fused_head_bf16.cu): the
    ring, h [rows][H+8] bf16 (or the final layer's u, shift and warp sums),
    the activations [rows][8TF+8] bf16 (or rank 0's final sums), the norms'
    exchange, the mbarriers (each stage's full and empty, the consumers'
    cluster barrier), and 1024 bytes to align the base."""
    hq, cf = h // CLUSTER, CLUSTER * tf
    hb = max(rows * (h + 8) * 2, 4 * nrc * (2 * hq + _WARPS * 2 * lat))
    ab = max(rows * (cf + 8) * 2, 4 * CLUSTER * nrc * (2 * lat + 1))
    return (stages * stage_bytes + _up(hb, 16) + _up(ab, 16) + _up(4 * CLUSTER * rows, 16)
            + 8 * (2 * stages + 1) + 1024)


class HeadPlan(NamedTuple):
    tf: int           # gate/up columns per CTA, a multiple of 8
    tiles: int        # CTAs that get F columns
    clusters: int     # clusters launched
    rows: int         # rows per row group: 8 or 16
    nrc: int          # rows a cluster finishes in a group, at most
    ku: int           # gate/up rows per ring chunk
    kd: int           # down rows per ring chunk
    wb: int           # columns of a down box
    nbd: int          # down boxes per chunk
    stages: int       # ring stages
    stage_bytes: int  # bytes per stage
    smem: int         # shared memory per CTA, bytes


def head_plan(n: int, h: int, f: int, lat: int, sms: int, clusters: int) -> HeadPlan:
    """The kernel's launch for n rows, width h, FFN width f and latent `lat`
    on a card of `sms` SMs that holds `clusters` clusters of CLUSTER CTAs at
    once: the F columns spread over all their CTAs in 8-column units, only
    the clusters that get columns launched; row groups of 16 rows (8 where n
    is at most 8); then the ring takes the shared memory left, in three or
    more stages: down chunks of the most rows (dividing the cluster's 8TF
    rows) that fit a third of it, and gate/up chunks of the most rows (a power
    of two dividing h) no larger (the chunk sizes measured fastest on the
    H100 at both heads)."""
    if h % 128 or h // CLUSTER > _MAX_HQ or f % 8 or lat % 8:
        raise ValueError(f"the bf16 head kernel takes H in multiples of 128 up to "
                         f"{CLUSTER * _MAX_HQ}, F and the latent in multiples of 8, got H={h}, "
                         f"F={f}, latent {lat}")
    ctas = min(clusters, sms // CLUSTER) * CLUSTER
    if ctas < 1:
        raise ValueError(f"no cluster of {CLUSTER} CTAs fits a card of {sms} SMs")
    # the CTAs tile the columns of gate's and up's maps: F + 8 of them
    # (csrc/fused_head_bf16.cu, `Maps`)
    tf = _up(-(-(f + 8) // ctas), 8)
    if tf > 256:
        raise ValueError(f"the bf16 head kernel's column slices ({tf} of F={f} on {ctas} CTAs) "
                         f"exceed a tensor-map box")
    tiles = -(-(f + 8) // tf)
    ncl = -(-tiles // CLUSTER)
    rows = 16 if n > 8 else 8
    nrc = -(-rows // ncl)
    ring = _SMEM_MAX - head_smem(h, tf, rows, lat, nrc, 0, 0)
    target = max(8192, ring // 3)
    kd = next((k for k in (256, 128, 64, 32) if (CLUSTER * tf) % k == 0
               and _wd_bytes(k, h) <= target), 16)
    fit = max(_wd_bytes(kd, h), 8192)
    ku = next((k for k in (256, 128, 64, 32) if h % k == 0 and _gu_bytes(k, tf) <= fit), 16)
    stage_bytes = _up(max(_gu_bytes(ku, tf), _wd_bytes(kd, h), 16 * (lat + 8)), 1024)
    stages = ring // (stage_bytes + 16)  # each stage has two 8-byte mbarriers
    if stages < 2:
        raise ValueError(f"the bf16 head kernel does not fit shared memory at H={h}, F={f}, "
                         f"{rows} rows, on {clusters} clusters")
    return HeadPlan(tf, tiles, ncl, rows, nrc, ku, kd, *_wd_boxes(h), stages, stage_bytes,
                    head_smem(h, tf, rows, lat, nrc, stages, stage_bytes))


_PLANS: Dict[tuple, HeadPlan] = {}


def plan_for(x: torch.Tensor, f: int, lat: int) -> HeadPlan:
    """`head_plan` for x [N, H] on its card, made once per device and shape,
    for the clusters that fit the card at once (`cuda_build.fitting_plan`)."""
    n, h = x.shape
    key = (str(x.device), n, h, f, lat)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _library()
        sms = cuda_build.sm_count(x.device)

        def fit(smem):
            out = ctypes.c_int(0)
            rc = lib.vv_head_bf16_clusters(smem, ctypes.byref(out))
            if rc != 0:
                raise RuntimeError(f"vv_head_bf16_clusters failed with code {rc}")
            return out.value

        with torch.cuda.device(x.device):
            plan = cuda_build.fitting_plan(
                x.device, lambda ncl: head_plan(n, h, f, lat, sms, ncl), fit,
                "the bf16 head kernel")
        _PLANS[key] = plan
    return plan


def _check(pk, x, layer_mods, final_mod, final_linear):
    n, h = x.shape
    nl = len(pk["gate"])
    f = pk["gate"][0].shape[1]
    want = {"gate": (h, f), "up": (h, f), "down": (f, h), "norm_w": (h,)}
    for k, shape in want.items():
        if len(pk[k]) != nl or any(tuple(t.shape) != shape for t in pk[k]):
            raise ValueError(f"pack {k} must hold {nl} tensors of shape {shape}")
    if tuple(layer_mods.shape) != (nl, n, 3 * h) or tuple(final_mod.shape) != (n, 2 * h):
        raise ValueError(f"modulations {tuple(layer_mods.shape)} / {tuple(final_mod.shape)} "
                         f"do not fit x {tuple(x.shape)} and {nl} layers")
    if final_linear.dim() != 2 or final_linear.shape[0] != h:
        raise ValueError(f"final_linear must be [{h}, latent], got {tuple(final_linear.shape)}")
    mapped = [final_linear, *(t for k in _MAPPED for t in pk[k])]
    for t in (x, layer_mods, final_mod, *mapped, *pk["norm_w"]):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the bf16 head kernel takes bfloat16 operands, one is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on {t.device}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (x, layer_mods, final_mod)):
        raise ValueError("x and the modulations must be contiguous and 16-byte aligned")
    if not all(t.is_contiguous() for t in (*mapped, *pk["norm_w"])):
        raise ValueError("the bf16 head kernel reads contiguous weights; one is not")
    if any(g.data_ptr() % 16 != u.data_ptr() % 16 for g, u in zip(pk["gate"], pk["up"])):
        raise ValueError("the bf16 head kernel tiles a layer's gate and up alike: they must "
                         "start at the same offset into a 16-byte unit")


def fused_head_bf16_step(pk, x: torch.Tensor, layer_mods: torch.Tensor,
                         final_mod: torch.Tensor, final_linear: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """One denoise step -> v-prediction [N, latent] in bf16.  CUDA tensors
    launch the kernel (one cluster launch, counted once); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return fused_head_bf16_step_ref(pk, x, layer_mods, final_mod, final_linear, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_bf16_step runs on cuda or cpu, not {x.device}")
    final_linear = final_linear.contiguous()
    _check(pk, x, layer_mods, final_mod, final_linear)
    n, h = x.shape
    nl, f, lat = len(pk["gate"]), pk["gate"][0].shape[1], final_linear.shape[1]
    plan = plan_for(x, f, lat)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, bar = workspace(x.device, stream, plan.clusters, plan.rows, h)
    out = torch.empty((n, lat), dtype=x.dtype, device=x.device)
    ptrs = {k: (ctypes.c_void_p * nl)(*(t.data_ptr() for t in pk[k])) for k in _LAYER_KEYS}
    with torch.cuda.device(x.device):
        rc = _library().vv_head_bf16(
            x.data_ptr(), layer_mods.data_ptr(), final_mod.data_ptr(), final_linear.data_ptr(),
            *(ptrs[k] for k in _LAYER_KEYS), out.data_ptr(), part.data_ptr(), bar.data_ptr(),
            n, h, f, nl, lat, plan.rows, plan.tf, plan.clusters, plan.ku, plan.kd, plan.wb,
            plan.nbd, plan.stages, plan.stage_bytes, plan.nrc, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_head_bf16 kernel failed with code {rc}")
    fused_head_bf16_step.launches += 1
    return out


fused_head_bf16_step.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_head_bf16")
    p, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    for fn, args in ((lib.vv_head_bf16, [p] * 4 + [pp] * 4 + [p] * 3 + [i] * 15
                      + [ctypes.c_float, p]),
                     (lib.vv_head_bf16_clusters, [ctypes.c_longlong, ctypes.POINTER(i)])):
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def weight_bytes(pk) -> int:
    """Bytes of the layers' gate/up/down (what one solver step streams,
    besides the modulations, norm weights and the final linear)."""
    return sum(t.numel() * t.element_size() for k in ("gate", "up", "down") for t in pk[k])


__all__ = ["takes", "pack", "head_plan", "head_smem", "HeadPlan", "plan_for",
           "fused_head_bf16_step", "fused_head_bf16_step_ref", "weight_bytes"]
