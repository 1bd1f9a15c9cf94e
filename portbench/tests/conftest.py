"""Shared pieces of the benchmark's own tests: the tiny configuration and
traffic under data/, a cell made of them, and a run of it on the CPU."""
import json
import os

import pytest
import torch

from portbench import harness

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def tiny_cell(limits=None) -> harness.Cell:
    """A cell of the tiny configuration and podcast traffic, judged by
    `limits` (default: the 1.5B podcast cell's own)."""
    with open(os.path.join(DATA, "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(DATA, "tiny-podcast.json")) as f:
        tr = json.load(f)
    if limits is None:
        limits = harness.resolve("vv1.5b-podcast-b8").limits
    return harness.Cell({"name": "tiny", "config": "tiny", "traffic": "tiny-podcast", "chips": 1},
                        {"name": "tiny", "file": os.path.join(DATA, "tiny.json")}, cfg, tr,
                        limits, [{"name": "audio_s_per_s", "unit": "audio-s/s"},
                                 {"name": "setup_s", "unit": "s"}], [])


def run_tiny(seed=3, seconds=0.3, hooks=None, trace=False, limits=None):
    """One run of the tiny cell on the CPU (the harness's look for a chip
    left out): (outcome, judged checks)."""
    cell = tiny_cell(limits)
    out = harness.execute(harness.Run(cell, seed, seconds, trace, torch.device("cpu"),
                                      dict(hooks or {})))
    return out, harness.judge(out.compared, cell.limits)


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
