"""Dense towers: ``MLP`` (layer by layer, plain PyTorch matmuls) and
``FusedMLP`` (the whole relu stack in one fused CUDA kernel each way)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.kernels import dispatch


class MLP(nn.Module):
    """Relu ``Linear`` stack; ``out_dim`` (if set) appends a final linear
    layer with no activation.  ``dtype`` is the COMPUTE dtype (params stay
    f32): as a flax ``Dense(dtype=bf16)``, each layer rounds its input,
    weight and bias to it.  ``None`` computes in the promoted input type."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int],
                 out_dim: int | None = None, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        dims = [in_dim, *hidden_units] + ([out_dim] if out_dim is not None else [])
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(dims, dims[1:])
        )
        self.num_hidden = len(hidden_units)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            dt = self.dtype if self.dtype is not None else torch.promote_types(
                x.dtype, lin.weight.dtype)
            x = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if i < self.num_hidden:
                x = torch.relu(x)
        return x


class FusedMLP(nn.Module):
    """Relu MLP stack through the fused kernels
    (``dispatch.FusedMLPFunction``: forward ``fused_mlp_forward``, backward
    ``fused_mlp_backward``, which recomputes the hidden layers): hidden
    activations never leave the forward kernel.  Numerically the MLP with bf16 matmul inputs and f32
    accumulation (``mm_bf16``) or exact f32.  Params are ``kernel_i``
    (in, out) and ``bias_i`` (1, out), the JAX package's FusedMLP layout."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], out_dim: int,
                 mm_bf16: bool = True, device=None):
        super().__init__()
        dims = [in_dim, *hidden_units, out_dim]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            w = torch.randn((a, b), device=device) / math.sqrt(a)  # lecun normal
            self.register_parameter(f"kernel_{i}", nn.Parameter(w))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros((1, b), device=device)))
        self.num_layers = len(dims) - 1
        self.mm_bf16 = mm_bf16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = [getattr(self, f"kernel_{i}") for i in range(self.num_layers)]
        bs = [getattr(self, f"bias_{i}") for i in range(self.num_layers)]
        return dispatch.FusedMLPFunction.apply(x.float().contiguous(), self.mm_bf16,
                                               *ws, *bs)
