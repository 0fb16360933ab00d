"""DCN (the port of ``recsys_tpu/models/ctr/dcn.py``): an explicit cross
network and a deep relu MLP in parallel over the flattened field embeddings
and the dense features, then one linear logit over both outputs."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.interactions import CrossNetwork
from recsys_tpu_torch.ops.init import dense_init_
from recsys_tpu_torch.ops.mlp import MLP


class DCN(nn.Module):
    """``cross_layers`` crossing layers beside an MLP of ``hidden_units``
    (``dropout_rate`` after each hidden layer in training)."""

    def __init__(self, schema: FeatureSchema, cross_layers: int = 2,
                 hidden_units: Sequence[int] = (256, 128, 64), dropout_rate: float = 0.0,
                 sparse_embed_grads: bool = False, embed_kw: dict | None = None,
                 device=None):
        super().__init__()
        self.schema = schema
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.has_dense = schema.num_dense > 0
        width = schema.num_sparse * schema.embed_dim + schema.num_dense
        self.cross = CrossNetwork(width, cross_layers, device=device)
        self.mlp = MLP(width, hidden_units, dropout_rate=dropout_rate, device=device)
        deep_out = hidden_units[-1] if len(hidden_units) else width
        self.out = dense_init_(nn.Linear(width + deep_out, 1, device=device))

    def forward(self, batch: dict) -> torch.Tensor:
        field_embs = self.embedding(batch["sparse"])
        x0 = field_embs.reshape(field_embs.shape[0], -1)
        if self.has_dense:
            x0 = torch.cat([x0, batch["dense"]], dim=-1)
        return self.out(torch.cat([self.cross(x0), self.mlp(x0)], dim=-1))[..., 0]
