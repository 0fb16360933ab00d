"""MMoE, the multi-gate mixture of experts (the port's copy of
``recsys_tpu/models/ctr/mmoe.py``): one bank of distinct experts (one
``einsum`` a layer), a softmax gate and a tower a task.  Returns logits
{task: (B,)}.

Batch: ``sparse`` (B, F) where the schema has sparse fields, ``dense``
where it has dense ones; the experts and gates read their concatenation.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.experts import ExpertBank, SoftmaxGate, mix
from recsys_tpu_torch.ops.mlp import MLP


def multitask_input(model: nn.Module, batch: dict) -> torch.Tensor:
    """[flattened sparse embeddings, dense] of a multi-task model's batch,
    each part where ``model.schema`` has such fields."""
    parts = []
    if model.schema.num_sparse:
        sparse = batch["sparse"]
        parts.append(model.embedding(sparse).reshape(sparse.shape[0], -1))
    if model.schema.num_dense:
        parts.append(batch["dense"])
    return torch.cat(parts, dim=-1)


def input_width(schema: FeatureSchema) -> int:
    return schema.num_sparse * schema.embed_dim + schema.num_dense


class MMoE(nn.Module):
    """``embedding`` (where the schema has sparse fields), ``experts`` the
    bank of ``num_experts``; ``gates`` and ``towers`` ``nn.ModuleDict``s
    keyed as the flax modules, ``gate_{task}`` and ``tower_{task}``."""

    def __init__(self, schema: FeatureSchema, task_names: Sequence[str] = ("ctr", "cvr"),
                 num_experts: int = 6, expert_units: Sequence[int] = (64, 32),
                 tower_units: Sequence[int] = (32,), dropout_rate: float = 0.0,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.task_names = tuple(task_names)
        in_dim = input_width(schema)
        self.embedding = StackedEmbedding(schema, device=device, **(embed_kw or {})) \
            if schema.num_sparse else None
        self.experts = ExpertBank(num_experts, in_dim, expert_units, device=device)
        self.gates = nn.ModuleDict({f"gate_{t}": SoftmaxGate(in_dim, num_experts, device=device)
                                    for t in self.task_names})
        self.towers = nn.ModuleDict({
            f"tower_{t}": MLP(expert_units[-1], tower_units, out_dim=1,
                              dropout_rate=dropout_rate, device=device)
            for t in self.task_names})

    def forward(self, batch: dict) -> dict:
        x = multitask_input(self, batch)
        experts = self.experts(x)  # (B, E, O)
        return {t: self.towers[f"tower_{t}"](mix(experts, self.gates[f"gate_{t}"](x)))[..., 0]
                for t in self.task_names}
