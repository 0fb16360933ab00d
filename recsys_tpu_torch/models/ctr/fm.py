"""Factorization Machine for CTR ranking (the port of
``recsys_tpu/models/ctr/fm.py``).

  logit = bias + Σ_f w[id_f] + dense·w_dense + 0.5·Σ_d((Σ_f v_fd)² − Σ_f v_fd²)

Categorical fields take their latent vectors from the tables; each dense
feature enters as its value times a learned vector ``v_dense``, so at the
Criteo widths the bi-interaction kernel sees 26 + 13 = 39 fields.
"""
from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.ops.embedding import SparseLinear, StackedEmbedding


class FM(nn.Module):
    """``sparse_embed_grads`` turns on the tables' ``perturb_out`` tap (for
    ``Trainer``'s fused embedding optimizers); ``embed_kw`` passes
    ``param_dtype`` / ``num_groups`` to the tables."""

    def __init__(self, schema: FeatureSchema, sparse_embed_grads: bool = False,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.linear = SparseLinear(schema, device=device)
        self.bias = nn.Parameter(torch.zeros((), device=device))
        nd, d = schema.num_dense, schema.embed_dim
        self.has_dense = nd > 0
        if self.has_dense:
            self.v_dense = nn.Parameter(torch.randn((nd, d), device=device) * 0.05)
            self.w_dense = nn.Parameter(torch.zeros(nd, device=device))

    def forward(self, batch: dict) -> torch.Tensor:
        sparse = batch["sparse"]
        field_embs = self.embedding(sparse)  # (B, F_s, D)
        first = self.linear(sparse)  # (B,)
        if self.has_dense:
            dense = batch["dense"]
            field_embs = torch.cat([field_embs, dense[..., None] * self.v_dense[None]], dim=1)
            first = first + dense @ self.w_dense
        return self.bias + first + dispatch.fm_pairwise(field_embs)
