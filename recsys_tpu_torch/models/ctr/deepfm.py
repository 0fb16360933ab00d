"""DeepFM (the port of ``recsys_tpu/models/ctr/deepfm.py``): shared field
embeddings feed an FM head (first order plus the bi-interaction kernel over
the sparse fields) and a deep relu MLP over the flattened embeddings and the
dense features; the logit is their sum."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.ops.embedding import SparseLinear, StackedEmbedding
from recsys_tpu_torch.ops.mlp import MLP


class DeepFM(nn.Module):
    """Options as ``FM``'s, plus the deep head's ``hidden_units`` and
    ``dropout_rate``."""

    def __init__(self, schema: FeatureSchema, hidden_units: Sequence[int] = (256, 128, 64),
                 dropout_rate: float = 0.0, sparse_embed_grads: bool = False,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.linear = SparseLinear(schema, device=device)
        self.has_dense = schema.num_dense > 0
        deep_in = schema.num_sparse * schema.embed_dim + schema.num_dense
        self.mlp = MLP(deep_in, hidden_units, out_dim=1, dropout_rate=dropout_rate,
                       device=device)

    def forward(self, batch: dict) -> torch.Tensor:
        sparse = batch["sparse"]
        field_embs = self.embedding(sparse)  # (B, F, D)
        fm_logit = self.linear(sparse) + dispatch.fm_pairwise(field_embs)
        deep_in = field_embs.reshape(field_embs.shape[0], -1)
        if self.has_dense:
            deep_in = torch.cat([deep_in, batch["dense"]], dim=-1)
        return fm_logit + self.mlp(deep_in)[..., 0]
