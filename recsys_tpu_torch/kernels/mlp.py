"""Plain PyTorch fused-MLP forward: the ground truth for the CUDA kernel
``csrc/mlp_fwd.cu`` and the path a CPU tensor takes.

It repeats the rounding of the TPU kernel's body (recsys_tpu's
``kernels/pallas/mlp_tpu.py::_fwd_kernel``): the input is cast to the
matmul dtype; each layer is ``z = h @ W`` accumulated in f32 plus the f32
bias, relu on every layer but the last; and every layer's output, the last
one included, is rounded to the matmul dtype before the final ``.float()``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def mlp_forward(x: torch.Tensor, ws: Sequence[torch.Tensor],
                bs: Sequence[torch.Tensor], mm_bf16: bool = True) -> torch.Tensor:
    """x (B, D0) f32; ws [(D_{i-1}, D_i)] f32; bs [(D_i,)] f32 -> (B, D_k) f32."""
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    h = x.to(mm)
    for i, (w, b) in enumerate(zip(ws, bs)):
        # bf16 x bf16 products are exact in f32, so the f32 matmul of the
        # rounded operands is the f32-accumulated bf16 product
        z = torch.mm(h.float(), w.to(mm).float()) + b.reshape(-1).float()
        if i < len(ws) - 1:
            z = torch.relu(z)
        h = z.to(mm)
    return h.float()
