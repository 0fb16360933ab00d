"""AutoInt (the port of ``recsys_tpu/models/ctr/autoint.py``): stacked
multi-head self-attention over the field embeddings, each layer with a relu
residual, then one linear logit over the flattened fields.  Each dense
feature enters as its value times a learned vector ``v_dense``, an extra
field.  At the Criteo widths the attention runs over 39 fields with 2 heads
of width 8, through the flash-attention kernels on a CUDA tensor."""
from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.attention import Dropout, MultiHeadAttention
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.init import dense_init_


class AutoInt(nn.Module):
    """``num_layers`` interacting layers of ``num_heads`` heads;
    ``dropout_rate`` > 0 drops after each layer in training."""

    def __init__(self, schema: FeatureSchema, num_layers: int = 3, num_heads: int = 2,
                 dropout_rate: float = 0.0, sparse_embed_grads: bool = False,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        d, nd = schema.embed_dim, schema.num_dense
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.has_dense = nd > 0
        if self.has_dense:
            self.v_dense = nn.Parameter(torch.randn((nd, d), device=device) * 0.05)
        self.attention = nn.ModuleList(
            MultiHeadAttention(d, num_heads, use_residual=True, device=device)
            for _ in range(num_layers))
        self.drops = nn.ModuleList(Dropout(dropout_rate) for _ in range(num_layers)) \
            if dropout_rate > 0 else None
        self.out = dense_init_(nn.Linear((schema.num_sparse + nd) * d, 1, device=device))

    def forward(self, batch: dict) -> torch.Tensor:
        x = self.embedding(batch["sparse"])  # (B, F, D)
        if self.has_dense:
            x = torch.cat([x, batch["dense"][..., None] * self.v_dense[None]], dim=1)
        for i, layer in enumerate(self.attention):
            x = layer(x)
            if self.drops is not None:
                x = self.drops[i](x)
        return self.out(x.reshape(x.shape[0], -1))[..., 0]
