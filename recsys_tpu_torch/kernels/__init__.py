"""Hand-written CUDA kernels for Hopper with plain PyTorch versions beside.

Routing follows the tensor, not the environment: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.  There is no
switch that moves a CUDA tensor onto the plain path.
"""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit request this raises, so a run
    meant for the GPU never falls back to the CPU unnoticed."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")
