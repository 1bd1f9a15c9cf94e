"""Builds the hand-written CUDA kernels of `csrc/` and loads them with ctypes.

Each source compiles with `nvcc` for Hopper (`sm_90a`) into a shared library
with a plain C interface, at first use, into a build directory that git
ignores (`vibevoice_tpu_torch/_build/`, or `$VIBEVOICE_TORCH_BUILD_DIR`).  A
library's file name carries a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing here runs at import.
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
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}-{digest}.so")


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


__all__ = ["SOURCES", "build_all", "load", "build_dir"]
