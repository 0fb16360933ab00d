"""Plain PyTorch fused-MLP forward and backward: the ground truth for the
CUDA kernels ``csrc/mlp_fwd.cu`` and ``csrc/mlp_bwd.cu`` and the path a CPU
tensor takes.

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


def mlp_backward(x: torch.Tensor, g: torch.Tensor, ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor], mm_bf16: bool = True):
    """Gradients of :func:`mlp_forward` given the output cotangent ``g``
    (B, D_k) f32 -> (dx (B, D0) f32, [dW_i (D_{i-1}, D_i) f32],
    [db_i f32 shaped like b_i]).

    It repeats the rounding of the TPU kernel's body (``_bwd_kernel``): the
    hidden layers are recomputed as the forward does, each rounded to the
    matmul dtype; ``dh = g`` is rounded; walking the layers in reverse,
    below the last layer ``dh`` is masked by ``h_{i+1} > 0`` and rounded,
    then ``dW_i = h_iᵀ·dh`` and ``db_i = Σ dh`` in f32, then
    ``dh = dh·W_iᵀ`` in f32, rounded."""
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    n = len(ws)
    hs = [x.to(mm)]
    for i in range(n - 1):  # the last layer's output is not needed
        z = torch.mm(hs[-1].float(), ws[i].to(mm).float()) + bs[i].reshape(-1).float()
        hs.append(torch.relu(z).to(mm))
    dh = g.to(mm)
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            dh = (dh.float() * (hs[i + 1].float() > 0)).to(mm)
        dws[i] = torch.mm(hs[i].float().t(), dh.float())
        dbs[i] = dh.float().sum(0).reshape(bs[i].shape)
        dh = torch.mm(dh.float(), ws[i].to(mm).float().t()).to(mm)
    return dh.float(), dws, dbs

