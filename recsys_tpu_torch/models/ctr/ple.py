"""PLE, progressive layered extraction (the port's copy of
``recsys_tpu/models/ctr/ple.py``): each level has an expert bank a task and
a shared bank; a task's gate mixes [its experts, the shared ones], queried
by the task's representation, and, below the last level, the shared gate
mixes every expert for the next level's shared input.  The last level
feeds a tower a task.  Returns logits {task: (B,)}.

Batch: as MMoE's.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.models.ctr.mmoe import input_width, multitask_input
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.experts import ExpertBank, SoftmaxGate, mix
from recsys_tpu_torch.ops.mlp import MLP


class PLE(nn.Module):
    """``embedding`` (where the schema has sparse fields); ``experts``,
    ``gates`` and ``towers`` ``nn.ModuleDict``s keyed as the flax modules:
    ``l{level}_experts_{task|shared}``, ``l{level}_gate_{task|shared}``
    (no shared gate at the last level) and ``tower_{task}``."""

    def __init__(self, schema: FeatureSchema, task_names: Sequence[str] = ("ctr", "cvr"),
                 num_levels: int = 2, specific_experts: int = 2, shared_experts: int = 2,
                 expert_units: Sequence[int] = (64, 32), tower_units: Sequence[int] = (32,),
                 dropout_rate: float = 0.0, embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.task_names = tuple(task_names)
        self.num_levels = num_levels
        self.embedding = StackedEmbedding(schema, device=device, **(embed_kw or {})) \
            if schema.num_sparse else None
        n_tasks, out = len(self.task_names), expert_units[-1]
        experts, gates = {}, {}
        for level in range(num_levels):
            in_dim = input_width(schema) if level == 0 else out
            for t in self.task_names:
                experts[f"l{level}_experts_{t}"] = ExpertBank(specific_experts, in_dim,
                                                              expert_units, device=device)
                gates[f"l{level}_gate_{t}"] = SoftmaxGate(
                    in_dim, specific_experts + shared_experts, device=device)
            experts[f"l{level}_experts_shared"] = ExpertBank(shared_experts, in_dim,
                                                             expert_units, device=device)
            if level < num_levels - 1:
                gates[f"l{level}_gate_shared"] = SoftmaxGate(
                    in_dim, n_tasks * specific_experts + shared_experts, device=device)
        self.experts, self.gates = nn.ModuleDict(experts), nn.ModuleDict(gates)
        self.towers = nn.ModuleDict({
            f"tower_{t}": MLP(out, tower_units, out_dim=1, dropout_rate=dropout_rate,
                              device=device)
            for t in self.task_names})

    def forward(self, batch: dict) -> dict:
        x = multitask_input(self, batch)
        task_in, shared_in = [x] * len(self.task_names), x
        for level in range(self.num_levels):
            own = [self.experts[f"l{level}_experts_{t}"](task_in[i])
                   for i, t in enumerate(self.task_names)]  # each (B, Es, O)
            shared = self.experts[f"l{level}_experts_shared"](shared_in)  # (B, Eh, O)
            new_in = [mix(torch.cat([own[i], shared], dim=1),
                          self.gates[f"l{level}_gate_{t}"](task_in[i]))
                      for i, t in enumerate(self.task_names)]
            if level < self.num_levels - 1:
                shared_in = mix(torch.cat(own + [shared], dim=1),
                                self.gates[f"l{level}_gate_shared"](shared_in))
            task_in = new_in
        return {t: self.towers[f"tower_{t}"](task_in[i])[..., 0]
                for i, t in enumerate(self.task_names)}
