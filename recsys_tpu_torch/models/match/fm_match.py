"""FM-match: a two-tower factorization machine for retrieval (the port's
copy of ``recsys_tpu/models/match/fm_match.py``).

The logit is an FM over the user's and the item's field embeddings
together: each tower's ``SparseLinear`` first-order weights plus the
bi-interaction of the concatenated fields through ``dispatch.fm_pairwise``
(the FM kernel on a CUDA tensor).  ``user_embed`` and ``item_embed`` are
each tower's sum-pooled field embeddings, for inner-product retrieval.
"""
from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.ops.embedding import SparseLinear, StackedEmbedding


class FMMatch(nn.Module):
    """``batch['user_sparse']`` and ``batch['item_sparse']``: (B, F) ids of
    ``user_schema``'s and ``item_schema``'s fields, one embedding width."""

    def __init__(self, user_schema: FeatureSchema, item_schema: FeatureSchema, device=None):
        super().__init__()
        # the Trainer checks each key's ids against its schema
        self.sparse_schemas = {"user_sparse": user_schema, "item_sparse": item_schema}
        self.user_table = StackedEmbedding(user_schema, device=device)
        self.item_table = StackedEmbedding(item_schema, device=device)
        self.user_linear = SparseLinear(user_schema, device=device)
        self.item_linear = SparseLinear(item_schema, device=device)

    def user_embed(self, batch: dict) -> torch.Tensor:
        return self.user_table(batch["user_sparse"]).sum(dim=1)

    def item_embed(self, batch: dict) -> torch.Tensor:
        return self.item_table(batch["item_sparse"]).sum(dim=1)

    def forward(self, batch: dict) -> torch.Tensor:
        fields = torch.cat([self.user_table(batch["user_sparse"]),
                            self.item_table(batch["item_sparse"])], dim=1)
        first = self.user_linear(batch["user_sparse"]) + self.item_linear(batch["item_sparse"])
        return first + dispatch.fm_pairwise(fields)
