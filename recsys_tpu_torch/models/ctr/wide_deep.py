"""Wide&Deep (the port of ``recsys_tpu/models/ctr/wide_deep.py``): a linear
wide part over the dense features and the sparse ids' first-order weights,
and a deep relu MLP over the flattened embeddings and the dense features;
the logit is 0.5·(wide + deep)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import SparseLinear, StackedEmbedding
from recsys_tpu_torch.ops.interactions import LinearLogit
from recsys_tpu_torch.ops.mlp import MLP


class WideDeep(nn.Module):
    """Options as ``DeepFM``'s; ``wide_uses_sparse`` adds the first-order
    weights of the sparse ids to the wide part."""

    def __init__(self, schema: FeatureSchema, hidden_units: Sequence[int] = (256, 128, 64),
                 dropout_rate: float = 0.0, wide_uses_sparse: bool = True,
                 sparse_embed_grads: bool = False, embed_kw: dict | None = None,
                 device=None):
        super().__init__()
        self.schema = schema
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))
        self.has_dense = schema.num_dense > 0
        self.wide = LinearLogit(schema.num_dense, device=device) if self.has_dense else None
        self.linear = SparseLinear(schema, device=device) if wide_uses_sparse else None
        deep_in = schema.num_sparse * schema.embed_dim + schema.num_dense
        self.mlp = MLP(deep_in, hidden_units, out_dim=1, dropout_rate=dropout_rate,
                       device=device)

    def forward(self, batch: dict) -> torch.Tensor:
        sparse = batch["sparse"]
        field_embs = self.embedding(sparse)
        b = field_embs.shape[0]
        wide = torch.zeros(b, dtype=field_embs.dtype, device=field_embs.device)
        deep_in = field_embs.reshape(b, -1)
        if self.has_dense:
            wide = wide + self.wide(batch["dense"])
            deep_in = torch.cat([deep_in, batch["dense"]], dim=-1)
        if self.linear is not None:
            wide = wide + self.linear(sparse)
        return 0.5 * (wide + self.mlp(deep_in)[..., 0])
