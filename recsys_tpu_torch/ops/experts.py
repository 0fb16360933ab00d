"""Batched expert banks for the multi-task models MMoE and PLE (the port's
copy of ``recsys_tpu/ops/experts.py``): a bank of E distinct relu MLP
experts is one ``einsum`` a layer over stacked (E, in, out) weights, with
no loop over the experts."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.ops.init import dense_init_, lecun_normal_


class ExpertBank(nn.Module):
    """E parallel relu MLP experts, (B, in_dim) -> (B, E, hidden_units[-1]).
    Layer i is ``w{i}`` (E, in, out), drawn as flax's
    ``lecun_normal(batch_axis=(0,))`` (fan-in ``in``, each expert on its
    own), and ``b{i}`` (E, out), zero."""

    def __init__(self, num_experts: int, in_dim: int, hidden_units: Sequence[int],
                 device=None):
        super().__init__()
        self.num_experts = num_experts
        self.num_layers = len(hidden_units)
        for i, (a, b) in enumerate(zip([in_dim, *hidden_units], hidden_units)):
            w = lecun_normal_(torch.empty((num_experts, a, b), device=device), a)
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros((num_experts, b), device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :].expand(x.shape[0], self.num_experts, x.shape[-1])
        for i in range(self.num_layers):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            h = torch.relu(torch.einsum("bei,eio->beo", h, w) + b[None])
        return h


class SoftmaxGate(nn.Module):
    """A task's gate: (B, in_dim) -> softmax weights (B, E) over the
    experts, from a ``Dense`` with no bias (``dense``)."""

    def __init__(self, in_dim: int, num_experts: int, device=None):
        super().__init__()
        self.dense = dense_init_(nn.Linear(in_dim, num_experts, bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.dense(x), dim=-1)


def mix(experts: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The gate-weighted mixture: (B, E, O) and (B, E) -> (B, O)."""
    return torch.einsum("beo,be->bo", experts, gate)
