"""Dense towers: ``MLP`` (layer by layer, plain PyTorch matmuls) and
``FusedMLP`` (the whole relu stack in one fused CUDA kernel each way), and
the layers DIN's towers use: flax's ``BatchNorm``, ``Dice`` and ``PReLU``."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.ops.attention import Dropout
from recsys_tpu_torch.ops.init import dense_init_, lecun_normal_


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the last axis (not ``torch.nn.BatchNorm1d``,
    which differs in three ways).  In training it normalises by the batch's
    statistics, computed in f32 as flax's fast variance, E[x²] − E[x]²
    clipped at 0, and moves the buffers ``mean`` and ``var`` (initially 0
    and 1) to keep ``momentum`` of their old value and take 1 − momentum of
    the batch's biased variance; in eval it normalises by the buffers.
    ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias``, with ``scale`` (1)
    and ``bias`` (0) learned where ``use_scale``, ``use_bias``."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))
        self.scale = nn.Parameter(torch.ones(num_features, device=device)) if use_scale \
            else None
        self.bias = nn.Parameter(torch.zeros(num_features, device=device)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x - mean) * mul
        return y + self.bias if self.bias is not None else y


class Dice(nn.Module):
    """DIN's adaptive activation ``x·p + alpha·x·(1 − p)``, ``p`` the sigmoid
    of ``x`` normalised by a ``BatchNorm`` with no scale and no bias (eps
    1e-9); ``alpha`` per channel, initially 0."""

    def __init__(self, num_features: int, eps: float = 1e-9, momentum: float = 0.99,
                 device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(num_features, device=device))
        self.bn = BatchNorm(num_features, momentum, eps, use_scale=False, use_bias=False,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.bn(x))
        return x * p + self.alpha * x * (1.0 - p)


class PReLU(nn.Module):
    """``where(x >= 0, x, alpha·x)`` with a per-channel slope ``alpha``,
    initially 0.25 (``F.prelu`` differs at x = 0 in its gradient)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_features,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class MLP(nn.Module):
    """Relu ``Linear`` stack, initialised as flax's ``Dense`` layers;
    ``out_dim`` (if set) appends a final linear layer with no activation.
    ``dtype`` is the COMPUTE dtype (params stay f32): as a flax
    ``Dense(dtype=bf16)``, each layer rounds its input, weight and bias to
    it.  ``None`` computes in the promoted input type.
    ``dropout_rate`` > 0 drops after every hidden activation in training
    (``ops.attention.Dropout``, on the generator ``Trainer`` gives it)."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int],
                 out_dim: int | None = None, dtype: torch.dtype | None = None,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        dims = [in_dim, *hidden_units] + ([out_dim] if out_dim is not None else [])
        self.layers = nn.ModuleList(
            dense_init_(nn.Linear(a, b, device=device)) for a, b in zip(dims, dims[1:])
        )
        self.num_hidden = len(hidden_units)
        self.dtype = dtype
        self.drops = nn.ModuleList(Dropout(dropout_rate) for _ in hidden_units) \
            if dropout_rate > 0.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            dt = self.dtype if self.dtype is not None else torch.promote_types(
                x.dtype, lin.weight.dtype)
            x = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if i < self.num_hidden:
                x = torch.relu(x)
                if self.drops is not None:
                    x = self.drops[i](x)
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
            w = lecun_normal_(torch.empty((a, b), device=device), a)
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
