"""Tracing and profiling hooks: phase timers, a device trace and audio-s/s
counters.  The PyTorch port's own copy of `vibevoice_tpu/utils/profiling.py`.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _wait_for(tree):
    """Wait until the work that produces the CUDA tensors in `tree` is done
    (a synchronize of each tensor's device); CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)


class PhaseTimer:
    """Accumulating wall-clock timers per phase (prefill / decode / vocoder)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with `sync` (a tensor or a tree of them) the time
        runs until the device has computed it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _wait_for(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler trace of the block (the CPU, and the card where there is
    one), written as a Chrome trace to `logdir/trace.json` (chrome://tracing,
    Perfetto; `logdir` defaults to `vibevoice_trace` in the temp directory).  On the H100 card image with torch 2.11 the profiler lost every
    device kernel of a trace at random points of a process (PERF.md §7):
    check that a trace holds device kernels before reading it."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vibevoice_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def rtf_counter(audio_samples: int, wall_s: float, sample_rate: int = 24000,
                chips: int = 1) -> Dict[str, float]:
    audio_sec = audio_samples / sample_rate
    return {
        "audio_sec": round(audio_sec, 3),
        "wall_s": round(wall_s, 3),
        "rtf": round(audio_sec / wall_s, 4) if wall_s > 0 else 0.0,
        "audio_sec_per_s_per_chip": round(audio_sec / wall_s / chips, 4) if wall_s > 0 else 0.0,
    }


__all__ = ["PhaseTimer", "device_trace", "rtf_counter"]
