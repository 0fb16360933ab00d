"""YoutubeDNN retrieval (the port's copy of
``recsys_tpu/models/match/youtube_dnn.py``): a user tower over the pooled
watch history, optional profile fields and dense features, L2-normalised,
against an L2-normalised item table; trained with in-batch sampled softmax
and logQ correction (``train.losses.in_batch_sampled_softmax``) and served
by top-k over the whole catalog (``train.retrieval.topk_scores``).

The history pools through ``StackedEmbedding.pooled_lookup``, which takes
the pooled-gather kernel on a CUDA tensor.  ``forward`` returns {'user':
(B, D), 'item': (B, D)}; ``user_embed``, ``item_embed`` and
``all_item_embeddings`` feed retrieval.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels.embedding import check_mode
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.mlp import MLP


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


class YoutubeDNN(nn.Module):
    """``user_schema``: profile sparse fields and a varlen ``hist_field``
    (its vocabulary the item ids, 0 the pad); the item side is one id
    embedding, ``item_table`` (num_items, embed_dim), drawn normal(0.05).
    ``user_dense_dim`` is the width of an optional ``user_dense`` input
    (the JAX module infers it at init)."""

    sparse_key = "user_sparse"     # profile ids, checked against the schema

    def __init__(self, user_schema: FeatureSchema, num_items: int, embed_dim: int = 32,
                 hidden_units: Sequence[int] = (128, 64), hist_field: str = "hist_item",
                 pooling: str = "mean", dropout_rate: float = 0.0, user_dense_dim: int = 0,
                 device=None):
        super().__init__()
        check_mode(pooling)
        self.schema = user_schema
        self.num_items = num_items
        # item-id inputs, checked by Trainer
        self.id_vocabs = dict.fromkeys(("hist", "item_id"), num_items)
        self.hist_field = hist_field
        self.pooling = pooling
        self.pad_id = user_schema.field(hist_field).pad_id
        self.user_table = StackedEmbedding(user_schema, device=device)
        self.item_table = nn.Parameter(torch.randn(num_items, embed_dim, device=device) * 0.05)
        in_dim = user_schema.embed_dim * (1 + len(user_schema.sparse)) + user_dense_dim
        self.user_mlp = MLP(in_dim, hidden_units, out_dim=embed_dim,
                            dropout_rate=dropout_rate, device=device)

    def user_embed(self, batch: dict) -> torch.Tensor:
        hist = batch["hist"]  # (B, L)
        parts = [self.user_table.pooled_lookup(self.hist_field, hist, hist != self.pad_id,
                                               self.pooling)]
        profile = batch.get("user_sparse")
        if profile is not None and profile.shape[-1] > 0:
            parts.append(self.user_table(profile).reshape(profile.shape[0], -1))
        if batch.get("user_dense") is not None:
            parts.append(batch["user_dense"])
        return _l2(self.user_mlp(torch.cat(parts, -1)))

    def item_embed(self, item_ids: torch.Tensor) -> torch.Tensor:
        return _l2(F.embedding(item_ids.long(), self.item_table))

    def all_item_embeddings(self) -> torch.Tensor:
        return _l2(self.item_table)

    def forward(self, batch: dict) -> dict:
        return {"user": self.user_embed(batch), "item": self.item_embed(batch["item_id"])}
