"""Where the port's entry points run: on the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for and absent, rather than running
    quietly on the CPU.

    fp32 matmuls and convolutions are pinned to full fp32 (no TF32): the
    port's parity tolerances against the JAX package assume it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


__all__ = ["resolve_device"]
