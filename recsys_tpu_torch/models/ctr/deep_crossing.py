"""Deep&Crossing (the port of ``recsys_tpu/models/ctr/deep_crossing.py``):
the flattened field embeddings and the dense features go through a stack of
residual units, then one linear logit."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.attention import Dropout
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.interactions import ResidualUnit
from recsys_tpu_torch.ops.init import dense_init_


class DeepCrossing(nn.Module):
    """One ``ResidualUnit`` per entry of ``hidden_units`` (its inner width);
    ``dropout_rate`` > 0 drops after the stack in training."""

    def __init__(self, schema: FeatureSchema, hidden_units: Sequence[int] = (256, 256),
                 dropout_rate: float = 0.0, sparse_embed_grads: bool = False,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.has_dense = schema.num_dense > 0
        width = schema.num_sparse * schema.embed_dim + schema.num_dense
        self.residual = nn.ModuleList(ResidualUnit(width, h, device=device)
                                      for h in hidden_units)
        self.drop = Dropout(dropout_rate) if dropout_rate > 0 else None
        self.out = dense_init_(nn.Linear(width, 1, device=device))

    def forward(self, batch: dict) -> torch.Tensor:
        field_embs = self.embedding(batch["sparse"])
        x = field_embs.reshape(field_embs.shape[0], -1)
        if self.has_dense:
            x = torch.cat([x, batch["dense"]], dim=-1)
        for unit in self.residual:
            x = unit(x)
        if self.drop is not None:
            x = self.drop(x)
        return self.out(x)[..., 0]
