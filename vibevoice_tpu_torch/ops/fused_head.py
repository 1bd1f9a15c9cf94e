"""Fused int4 diffusion-head solver step: CUDA kernel and plain version.

Port of `vibevoice_tpu/ops/fused_head.py`.  The adaLN head (ref
modular_vibevoice_diffusion_head.py:191-280) runs once per solver step,
`ddpm_steps` times per frame, and each run re-reads every layer's gate/up/down
weights.  With `quantize_diffusion="int4k"` those weights are nibble-packed
(`pack_head_solver_q`) and one step is ONE kernel call.

`fused_head_solver_step` replaces the TPU kernel
`vibevoice_tpu/ops/fused_head.py:fused_head_solver_step` (Pallas `_kernel`).
On CUDA tensors it runs one cooperative launch of `csrc/fused_head.cu` (design
and bound are described there); on CPU tensors it runs
`fused_head_solver_step_ref`, the plain version with the same signature,
which is also the kernel's oracle.  Both take the layer modulations as
shift | scale | gate = mods[..., 0:H], [H:2H], [2H:3H].
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from . import cuda_build
from .fused_blocks import ffn_tile, row_group
from .int4_matmul import quantize_int4, unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def fused_head_solver_step(pack, x: torch.Tensor, layer_mods: torch.Tensor,
                           final_mod: torch.Tensor, final_linear: torch.Tensor,
                           eps: float) -> torch.Tensor:
    """One denoise step -> v-prediction [N, latent] in x's dtype.  CUDA tensors
    launch the kernel (one cooperative launch, counted once); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return fused_head_solver_step_ref(pack, x, layer_mods, final_mod, final_linear, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_solver_step runs on cuda or cpu, not {x.device}")
    final_linear = final_linear.contiguous()
    _check(pack, x, layer_mods, final_mod, final_linear)
    n, h = x.shape
    nl = pack["norms"].shape[0]
    f = pack["wgq"].shape[2]
    lat = final_linear.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tf, ntiles = ffn_tile(f, 2 * sms)  # two CTAs per SM co-reside
    rows_g = row_group(n, 1, h)
    out = torch.empty((n, lat), dtype=x.dtype, device=x.device)
    xg = torch.empty((n, h), dtype=torch.float32, device=x.device)
    part = torch.empty((ntiles, rows_g, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().vv_fused_head(
            x.data_ptr(), layer_mods.data_ptr(), final_mod.data_ptr(), final_linear.data_ptr(),
            *(pack[k].data_ptr() for k in ("norms", "wgq", "sg", "wuq", "su", "wdq", "sd")),
            out.data_ptr(), xg.data_ptr(), part.data_ptr(), n, h, f, nl, lat, rows_g, tf,
            ntiles, float(eps), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_head kernel failed with code {rc}")
    fused_head_solver_step.launches += 1
    return out


fused_head_solver_step.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_head")
    fn = lib.vv_fused_head
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def pack_bytes(pack) -> int:
    """Bytes of the head pack (what one solver step streams, besides the
    modulations and the final linear)."""
    return sum(t.numel() * t.element_size() for t in pack.values())


__all__ = ["pack_head_solver_q", "fused_head_solver_step", "fused_head_solver_step_ref",
           "pack_bytes"]
