"""Feature-interaction modules (the port's copy of
``recsys_tpu/ops/interactions.py``): the FM head, DCN's cross network,
DeepCrossing's residual unit, the wide part's linear logit, SENet's
squeeze-and-excitation over fields and the DLRM dot interaction as a
module.

Parameters keep the flax names (``w_first``, ``w{i}``/``b{i}``) or are
``nn.Linear``s initialised as flax's ``Dense``; ``convert`` maps the flax
trees onto them.  The FM and dot interactions run through
``kernels/dispatch.py``: the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor.
"""
from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.ops.init import dense_init_


class FMInteraction(nn.Module):
    """First- plus second-order FM over ``num_fields`` field embeddings:
    ``forward(field_embs (B, F, D), first_order_inputs (B, F) or None)``
    returns (B,).  The first-order weight ``w_first`` (F,) gives a
    per-example term; without ``first_order_inputs`` every field counts 1."""

    def __init__(self, num_fields: int, use_first_order: bool = True, device=None):
        super().__init__()
        self.use_first_order = use_first_order
        if use_first_order:
            self.w_first = nn.Parameter(torch.randn(num_fields, device=device) * 0.01)
            self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, field_embs: torch.Tensor,
                first_order_inputs: torch.Tensor | None = None) -> torch.Tensor:
        second = dispatch.fm_pairwise(field_embs)
        if not self.use_first_order:
            return second
        if first_order_inputs is None:
            first_order_inputs = torch.ones(field_embs.shape[:2], dtype=field_embs.dtype,
                                            device=field_embs.device)
        return first_order_inputs @ self.w_first + self.bias + second


class CrossNetwork(nn.Module):
    """DCN's explicit crossing, ``x_{l+1} = x0 · (x_l · w_l) + b_l + x_l``,
    with per-layer vectors ``w{l}`` (normal, std 0.01) and ``b{l}`` (zero)
    of the input's width ``dim``."""

    def __init__(self, dim: int, num_layers: int = 2, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w{i}", nn.Parameter(torch.randn(dim, device=device) * 0.01))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(dim, device=device)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x0 * (x @ getattr(self, f"w{i}"))[:, None] + getattr(self, f"b{i}") + x
        return x


class ResidualUnit(nn.Module):
    """DeepCrossing's block: ``relu(x + dense1(relu(dense0(x))))``, with
    ``dense0`` to ``hidden_dim`` and ``dense1`` back to the input's width."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.dense0 = dense_init_(nn.Linear(in_dim, hidden_dim, device=device))
        self.dense1 = dense_init_(nn.Linear(hidden_dim, in_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.dense1(torch.relu(self.dense0(x))))


class LinearLogit(nn.Module):
    """The wide part: (B, in_dim) dense features -> (B,) logit."""

    def __init__(self, in_dim: int, device=None):
        super().__init__()
        self.dense = dense_init_(nn.Linear(in_dim, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)[..., 0]


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the field axis, (B, F, D) -> (B, F, D):
    each field's mean over D, then ``dense0`` to ``max(1, F // reduction)``
    with relu and ``dense1`` back to F with a sigmoid, whose (B, F)
    weights scale the fields.  The JAX module reads F at init; here it is
    ``num_fields``."""

    def __init__(self, num_fields: int, reduction: int = 2, device=None):
        super().__init__()
        hidden = max(1, num_fields // reduction)
        self.dense0 = dense_init_(nn.Linear(num_fields, hidden, device=device))
        self.dense1 = dense_init_(nn.Linear(hidden, num_fields, device=device))

    def forward(self, field_embs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense0(field_embs.mean(dim=-1)))
        return field_embs * torch.sigmoid(self.dense1(h))[..., None]


class DotInteraction(nn.Module):
    """DLRM's pairwise dot interaction, (B, F, D) -> (B, P) f32.  Routed by
    (F, D) alone: where the kernel takes them (``dot_in_domain``), through
    ``dispatch.DotInteraction`` (the kernel on a CUDA tensor); elsewhere
    through the JAX package's XLA route, a batched f32 Gram matrix and the
    ``tril_pairs`` selection, whose gradient autograd takes, on every
    device."""

    def __init__(self, self_interaction: bool = False):
        super().__init__()
        self.self_interaction = self_interaction

    def forward(self, vectors: torch.Tensor) -> torch.Tensor:
        _, f, d = vectors.shape
        if int_ref.dot_in_domain(f, d, self.self_interaction):
            return dispatch.DotInteraction.apply(vectors.contiguous(), self.self_interaction)
        return int_ref.dot_interaction(vectors, self.self_interaction)
