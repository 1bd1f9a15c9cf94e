"""Builds the hand-written CUDA kernels of `csrc/` and loads them with ctypes.

Each source compiles with `nvcc` for Hopper (`sm_90a`) into a shared library
with a plain C interface, at first use, into a build directory that git
ignores (`vibevoice_tpu_torch/_build/`, or `$VIBEVOICE_TORCH_BUILD_DIR`).  A
library's file name carries a hash of its source and flags, so an edited source
(or of a shared header in csrc/) is rebuilt and a stale library is never
loaded.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
# kernel name -> source file in csrc/
SOURCES: Dict[str, str] = {
    "decode_attention": "decode_attention.cu",
    "int4_matmul": "int4_matmul.cu",
    "fused_block_chain": "fused_block_chain.cu",
    "fused_head": "fused_head.cu",
    "fused_stage": "fused_stage.cu",
    "flash_prefill": "flash_prefill.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("VIBEVOICE_TORCH_BUILD_DIR", os.path.join(PKG_DIR, "_build"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[Optional[subprocess.Popen], str, str]:
    """Start nvcc for `name` unless its library exists; returns (proc, tmp, dst)."""
    dst = _lib_path(name)
    if os.path.exists(dst):
        return None, "", dst
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, dst


def _finish(name: str, proc: Optional[subprocess.Popen], tmp: str, dst: str) -> str:
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{out}")
    os.replace(tmp, dst)  # atomic: a reader never sees a half-written library
    return out


def build_all(names: Optional[List[str]] = None) -> Tuple[float, Dict[str, str]]:
    """Compile every kernel source at once (one nvcc per source, in parallel).

    Returns (seconds, {name: compiler output}); raises if any build fails."""
    names = list(SOURCES) if names is None else names
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    logs = {n: _finish(n, *started[n]) for n in names}
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, *_start(name))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


_SMS: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, asked once per device."""
    import torch
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def fitting_plan(device, make_plan, clusters_that_fit, what: str):
    """The launch plan of a kernel whose clusters of 8 CTAs must all be
    resident at once (its grid barrier waits for every CTA): `make_plan(n)`
    plans for n clusters, at most one CTA per SM; `clusters_that_fit(smem)`
    asks the CUDA runtime how many clusters fit with `smem` bytes of shared
    memory a CTA.  Fewer clusters widen the columns per CTA and so its shared
    memory, so the question is asked again until the plan fits."""
    ncl = max(1, sm_count(device) // 8)
    for _ in range(8):
        plan = make_plan(ncl)
        fit = clusters_that_fit(plan.smem)
        if fit >= plan.clusters:
            return plan
        if fit < 1:
            raise RuntimeError(f"one cluster of {what} ({plan.smem} bytes of shared memory a CTA) "
                               f"does not fit {device}")
        ncl = fit
    raise RuntimeError(f"no launch of {what} fits the card")


__all__ = ["SOURCES", "build_all", "load", "build_dir", "sm_count", "fitting_plan"]
