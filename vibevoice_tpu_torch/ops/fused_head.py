"""Fused int4 diffusion-head solver step: CUDA kernel and plain version.

Port of `vibevoice_tpu/ops/fused_head.py`.  The adaLN head (ref
modular_vibevoice_diffusion_head.py:191-280) runs once per solver step,
`ddpm_steps` times per frame, and each run re-reads every layer's gate/up/down
weights.  With `quantize_diffusion="int4k"` those weights are nibble-packed
(`pack_head_solver_q`) and one step is ONE kernel call.

`fused_head_solver_step` replaces the TPU kernel
`vibevoice_tpu/ops/fused_head.py:fused_head_solver_step` (Pallas `_kernel`).
On CUDA tensors it runs one cluster launch of `csrc/fused_head.cu` (design
and bound are described there; `head_plan` sizes it, `fused_blocks.workspace`
holds its cached partials and barrier counter); on CPU tensors it runs
`fused_head_solver_step_ref`, the plain version with the same signature,
which is also the kernel's oracle.  Both take the layer modulations as
shift | scale | gate = mods[..., 0:H], [H:2H], [2H:3H].
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple

import torch

from . import cuda_build
from .fused_blocks import workspace
from .int4_matmul import quantize_int4, unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

CLUSTER = 8        # CTAs per cluster: the portable size
_THREADS = 256     # threads per CTA
_ROWS = 8          # rows per row group, at most (one register pass)
_BOX = 256         # the tensor map's box limit, in rows and in columns
_W2_MIN = 16384    # bytes of a wd ring stage, at least (unless the slice is smaller)
_SMEM_MAX = 227 * 1024


def pack_head_solver_q(head_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """int4 pack of the per-solver-step FFN weights (gate/up/down, per-channel
    scales) and the per-layer norm weights.  Build it from the original
    (unquantized) head."""
    layers = head_params["layers"]
    if any(isinstance(lp["gate"], dict) or "gateup" in lp for lp in layers):
        raise ValueError("pack_head_solver_q needs the original (unquantized) "
                         "diffusion-head weights")
    n = len(layers)
    h = layers[0]["norm_w"].shape[0]
    f = layers[0]["gate"].shape[1]
    dev = layers[0]["norm_w"].device
    pack = {"norms": torch.zeros((n, 8, h), dtype=torch.float32, device=dev)}
    for name, (k, cols) in (("g", (h, f)), ("u", (h, f)), ("d", (f, h))):
        pack[f"w{name}q"] = torch.zeros((n, k // 2, cols), dtype=torch.int8, device=dev)
        pack[f"s{name}"] = torch.zeros((n, 1, cols), dtype=torch.float32, device=dev)
    for i, lp in enumerate(layers):
        pack["norms"][i, 0] = lp["norm_w"].float()
        for name, src in (("g", "gate"), ("u", "up"), ("d", "down")):
            q = quantize_int4(lp[src])
            pack[f"w{name}q"][i] = q["qint4"]
            pack[f"s{name}"][i, 0] = q["scale4"][0]
    return {k: pack[k] for k in ("norms", "wgq", "sg", "wuq", "su", "wdq", "sd")}


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def fused_head_solver_step_ref(pack, x: torch.Tensor, layer_mods: torch.Tensor,
                               final_mod: torch.Tensor, final_linear: torch.Tensor,
                               eps: float) -> torch.Tensor:
    """Plain PyTorch solver step, fp32 math as in the TPU kernel: x [N, H]
    (after noisy_proj), layer_mods [L, N, 3H], final_mod [N, 2H],
    final_linear [H, latent] -> v-prediction [N, latent] in x's dtype."""
    h = x.shape[1]
    xs = x.float()
    for i in range(pack["norms"].shape[0]):
        mods = layer_mods[i].float()
        shift, scale, gate = mods[:, :h], mods[:, h:2 * h], mods[:, 2 * h:]
        hn = (_rms(xs, eps) * pack["norms"][i, 0]) * (1.0 + scale) + shift
        g = (hn @ unpack_int4(pack["wgq"][i]).float()) * pack["sg"][i, 0]
        u = (hn @ unpack_int4(pack["wuq"][i]).float()) * pack["su"][i, 0]
        a = (g / (1.0 + torch.exp(-g))) * u
        xs = xs + gate * ((a @ unpack_int4(pack["wdq"][i]).float()) * pack["sd"][i, 0])
    fm = final_mod.float()
    xn = _rms(xs, eps) * (1.0 + fm[:, h:2 * h]) + fm[:, :h]
    return (xn @ final_linear.float()).to(x.dtype)


def _check(pack, x, layer_mods, final_mod, final_linear):
    n, h = x.shape
    nl = pack["norms"].shape[0]
    f = pack["wgq"].shape[2]
    if h % 2 or f % 2:
        raise ValueError(f"the head kernel takes even H and F, got H={h}, F={f}")
    want = {"norms": (nl, 8, h), "wgq": (nl, h // 2, f), "sg": (nl, 1, f),
            "wuq": (nl, h // 2, f), "su": (nl, 1, f), "wdq": (nl, f // 2, h),
            "sd": (nl, 1, h)}
    for k, shape in want.items():
        if tuple(pack[k].shape) != shape:
            raise ValueError(f"pack {k} has shape {tuple(pack[k].shape)}, want {shape}")
        if pack[k].dtype != (torch.int8 if k.endswith("q") else torch.float32):
            raise TypeError(f"pack {k} has dtype {pack[k].dtype}")
    if tuple(layer_mods.shape) != (nl, n, 3 * h) or tuple(final_mod.shape) != (n, 2 * h):
        raise ValueError(f"modulations {tuple(layer_mods.shape)} / {tuple(final_mod.shape)} "
                         f"do not fit x {tuple(x.shape)} and {nl} layers")
    if final_linear.dim() != 2 or final_linear.shape[0] != h:
        raise ValueError(f"final_linear must be [{h}, latent], got {tuple(final_linear.shape)}")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in (layer_mods, final_mod, final_linear)):
        raise TypeError("x, the modulations and final_linear must share float32 or bfloat16")
    for t in [x, layer_mods, final_mod, final_linear, *pack.values()]:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_head_solver_step operands must be contiguous")


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def box_width(tf: int) -> int:
    """Bytes of a gate/up box row (`box_w` in csrc/fused_head.cu): a box
    starts at the 16-byte unit of the CTA's first column (k * tf, which is 0
    or 8 past one) and covers its tf columns in whole 16-byte units."""
    return _up(tf + (8 if tf % 16 else 0), 16)


def head_smem(h: int, tf: int, rows: int, kb: int, ring: int, r2: int, ring2: int,
              lat: int = 64) -> int:
    """Shared memory of one CTA of the head kernel (`h_layout` in
    csrc/fused_head.cu): the gate/up ring (`ring` stages of two boxes of kb
    rows of `box_width(tf)` bytes), the wd ring (`ring2` runs of r2 packed rows), h / the share /
    rank 0's final sums, x of the rank's columns and the final shift, the
    activations, the
    up-projection's K splits (then the final products' warp sums), the norms'
    partials and exchange, two of each small-operand buffer, the mbarriers,
    and 128 bytes to align the base."""
    wmax = _up(h // 4, CLUSTER) // CLUSTER * 4
    nkl, items = _THREADS // (tf // 4), rows * lat
    return (ring * 2 * _up(kb * box_width(tf), 128) + ring2 * _up(r2 * h, 128)
            + _up(4 * max(rows * h, 2 * CLUSTER * items + CLUSTER * rows), 16)
            + 2 * _up(4 * rows * wmax, 16) + _up(4 * rows * tf, 16)
            + _up(4 * max(nkl * tf, 2 * _THREADS // 32 * lat) * rows, 16)
            + _up(4 * (-(-wmax // 32) + CLUSTER + 1) * rows, 16)
            + 2 * _up(4 * (3 * rows * wmax + 2 * wmax + 2 * tf), 16)
            + 8 * (ring + ring2 + 2) + 128)


class HeadPlan(NamedTuple):
    tf: int        # F columns per CTA, a multiple of 8
    tiles: int     # CTAs that get columns
    clusters: int  # clusters launched
    rows: int      # rows per row group
    kb: int        # packed gate/up rows per tensor-map box (a ring stage)
    ring: int      # gate/up ring stages
    r2: int        # packed wd rows per bulk copy (a ring stage)
    ring2: int     # wd ring stages
    smem: int      # shared memory per CTA, bytes


def head_plan(n: int, h: int, f: int, sms: int, clusters: int, lat: int = 64) -> HeadPlan:
    """The head kernel's launch for n rows, width h and FFN width f on a card
    of `sms` SMs that holds `clusters` clusters of CLUSTER CTAs at once: the
    FFN columns spread over all their CTAs in 8-column units (whole packed
    words of gate/up, whole packed rows of wd; the gate/up boxes cover them
    in the tensor map's 16-byte units, `box_width`), only the clusters that get columns
    launched; row groups of at most 8 rows, as many as fit; gate/up
    in boxes of the most packed rows (at most 256) that divide h/2, wd in runs
    of whole packed rows that divide the CTA's tf/2, of 16 KB or more where
    the slice has them; the rings as deep as shared memory allows, at least 2
    stages where a layer has 2 chunks, so that the most bytes are in flight
    (at the 1.5B shape a whole layer's slice)."""
    if h % 16 or f % 16:
        raise ValueError(f"the head kernel takes H and F in multiples of 16, got H={h}, F={f}")
    ctas = min(clusters, sms // CLUSTER) * CLUSTER
    if ctas < 1:
        raise ValueError(f"no cluster of {CLUSTER} CTAs fits a card of {sms} SMs")
    tf = _up(-(-f // ctas), 8)
    if box_width(tf) > _BOX:
        raise ValueError(f"the head kernel's column slices ({tf} of F={f} on {ctas} CTAs) "
                         f"exceed a tensor-map box")
    tiles = -(-f // tf)
    kb = next(k for k in range(min(_BOX, h // 2), 0, -1) if (h // 2) % k == 0)
    nk = h // 2 // kb
    r2s = [r for r in range(tf // 2, 0, -1) if (tf // 2) % r == 0]
    r2_min = next((r for r in reversed(r2s) if r * h >= _W2_MIN), tf // 2)
    for rows in range(min(n, _ROWS), 0, -1):
        best = None
        for ring in range(nk, min(2, nk) - 1, -1):
            for r2 in r2s:
                if r2 < r2_min:
                    continue
                n2 = tf // 2 // r2
                for ring2 in range(n2, min(2, n2) - 1, -1):
                    smem = head_smem(h, tf, rows, kb, ring, r2, ring2, lat)
                    if smem > _SMEM_MAX:
                        continue
                    key = (ring * 2 * kb * tf + ring2 * r2 * h, r2)
                    if best is None or key > best[0]:
                        best = (key, HeadPlan(tf, tiles, -(-tiles // CLUSTER), rows, kb, ring,
                                              r2, ring2, smem))
                    break  # the deepest wd ring that fits, at this r2
        if best is not None:
            return best[1]
    raise ValueError(f"the head kernel does not fit shared memory at H={h}, F={f} "
                     f"on {clusters} clusters")


_PLANS: Dict[tuple, HeadPlan] = {}


def plan_for(x: torch.Tensor, f: int, lat: int) -> HeadPlan:
    """`head_plan` for x [N, H] on its card, made once per device, dtype and
    shape, for the clusters that fit the card at once
    (`cuda_build.fitting_plan`)."""
    n, h = x.shape
    key = (str(x.device), x.dtype, n, h, f, lat)
    plan = _PLANS.get(key)
    if plan is None:
        lib = _library()
        sms = cuda_build.sm_count(x.device)

        def fit(smem):
            out = ctypes.c_int(0)
            rc = lib.vv_fused_head_clusters(smem, _DTYPE_CODES[x.dtype], ctypes.byref(out))
            if rc != 0:
                raise RuntimeError(f"vv_fused_head_clusters failed with code {rc}")
            return out.value

        with torch.cuda.device(x.device):
            plan = cuda_build.fitting_plan(x.device, lambda ncl: head_plan(n, h, f, sms, ncl, lat),
                                           fit, "the head kernel")
        _PLANS[key] = plan
    return plan


_KEYS = ("norms", "wgq", "sg", "wuq", "su", "wdq", "sd")


def fused_head_solver_step(pack, x: torch.Tensor, layer_mods: torch.Tensor,
                           final_mod: torch.Tensor, final_linear: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """One denoise step -> v-prediction [N, latent] in x's dtype.  CUDA tensors
    launch the kernel (one cluster launch, counted once); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return fused_head_solver_step_ref(pack, x, layer_mods, final_mod, final_linear, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_solver_step runs on cuda or cpu, not {x.device}")
    final_linear = final_linear.contiguous()
    _check(pack, x, layer_mods, final_mod, final_linear)
    if any(pack[k].data_ptr() % 16 for k in _KEYS):
        raise ValueError("the head kernel's pack tensors must be 16-byte aligned")
    n, h = x.shape
    nl = pack["norms"].shape[0]
    f = pack["wgq"].shape[2]
    lat = final_linear.shape[1]
    plan = plan_for(x, f, lat)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, bar = workspace(x.device, stream, plan.clusters, plan.rows, h)
    out = torch.empty((n, lat), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().vv_fused_head(
            x.data_ptr(), layer_mods.data_ptr(), final_mod.data_ptr(), final_linear.data_ptr(),
            *(pack[k].data_ptr() for k in _KEYS), out.data_ptr(), part.data_ptr(),
            bar.data_ptr(), n, h, f, nl, lat, plan.rows, plan.tf, plan.clusters, plan.kb,
            plan.ring, plan.r2, plan.ring2, float(eps), _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_head kernel failed with code {rc}")
    fused_head_solver_step.launches += 1
    return out


fused_head_solver_step.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_head")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.vv_fused_head, [p] * 14 + [i] * 12 + [ctypes.c_float, i, p]),
                     (lib.vv_fused_head_clusters, [ctypes.c_longlong, i, ctypes.POINTER(i)])):
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def pack_bytes(pack) -> int:
    """Bytes of the head pack (what one solver step streams, besides the
    modulations and the final linear)."""
    return sum(t.numel() * t.element_size() for t in pack.values())


__all__ = ["pack_head_solver_q", "head_plan", "head_smem", "box_width", "plan_for",
           "fused_head_solver_step", "fused_head_solver_step_ref", "pack_bytes"]
