"""Two-tower retrieval: DSSM and its SENet variant (the port's copy of
``recsys_tpu/models/match/two_tower.py``).

Each tower embeds its sparse fields (``StackedEmbedding``), optionally
reweights them with an ``SEBlock``, flattens them (with optional dense
features) and maps them through an ``MLP`` to ``out_dim``.  In
``output_mode="score"`` the model returns ``gamma · cosine(user, item)``
(SENet clips the cosine at 0 first), a per-example logit for BCE; in
``"pair"`` it returns {'user', 'item'} for the in-batch sampled softmax.
``user_embed`` and ``item_embed`` feed retrieval.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.interactions import SEBlock
from recsys_tpu_torch.ops.mlp import MLP

OUTPUT_MODES = ("score", "pair")


def cosine(u: torch.Tensor, v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity (B, D) x (B, D) -> (B,)."""
    den = u.norm(dim=-1) * v.norm(dim=-1)
    return (u * v).sum(dim=-1) / den.clamp_min(eps)


class TwoTower(nn.Module):
    """``user_schema`` and ``item_schema`` hold each tower's sparse fields
    (``batch['user_sparse']`` and ``batch['item_sparse']``, (B, F) ids);
    ``user_dense_dim`` and ``item_dense_dim`` are the widths of optional
    ``user_dense`` and ``item_dense`` inputs (the JAX module infers them at
    init)."""

    def __init__(self, user_schema: FeatureSchema, item_schema: FeatureSchema,
                 user_units: Sequence[int] = (128, 64), item_units: Sequence[int] = (128, 64),
                 out_dim: int = 32, dropout_rate: float = 0.0, gamma: float = 1.0,
                 use_senet: bool = False, se_reduction: int = 2, output_mode: str = "score",
                 user_dense_dim: int = 0, item_dense_dim: int = 0, device=None):
        super().__init__()
        if output_mode not in OUTPUT_MODES:
            raise ValueError(f"output_mode={output_mode!r} not in {OUTPUT_MODES}")
        # the Trainer checks each key's ids against its schema
        self.sparse_schemas = {"user_sparse": user_schema, "item_sparse": item_schema}
        self.gamma = gamma
        self.use_senet = use_senet
        self.output_mode = output_mode
        self.user_table = StackedEmbedding(user_schema, device=device)
        self.item_table = StackedEmbedding(item_schema, device=device)
        nu, ni = len(user_schema.sparse), len(item_schema.sparse)
        self.user_mlp = MLP(nu * user_schema.embed_dim + user_dense_dim, user_units,
                            out_dim=out_dim, dropout_rate=dropout_rate, device=device)
        self.item_mlp = MLP(ni * item_schema.embed_dim + item_dense_dim, item_units,
                            out_dim=out_dim, dropout_rate=dropout_rate, device=device)
        if use_senet:
            self.user_se = SEBlock(nu, se_reduction, device=device)
            self.item_se = SEBlock(ni, se_reduction, device=device)

    def _tower(self, table, mlp, se, sparse, dense) -> torch.Tensor:
        embs = table(sparse)  # (B, F, D)
        if se is not None:
            embs = se(embs)
        x = embs.reshape(sparse.shape[0], -1)
        if dense is not None and dense.shape[-1] > 0:
            x = torch.cat([x, dense], dim=-1)
        return mlp(x)

    def user_embed(self, batch: dict) -> torch.Tensor:
        return self._tower(self.user_table, self.user_mlp,
                           self.user_se if self.use_senet else None,
                           batch["user_sparse"], batch.get("user_dense"))

    def item_embed(self, batch: dict) -> torch.Tensor:
        return self._tower(self.item_table, self.item_mlp,
                           self.item_se if self.use_senet else None,
                           batch["item_sparse"], batch.get("item_dense"))

    def forward(self, batch: dict):
        u, v = self.user_embed(batch), self.item_embed(batch)
        if self.output_mode == "pair":
            return {"user": u, "item": v}
        sim = cosine(u, v)
        if self.use_senet:
            sim = sim.clamp_min(0.0)  # SENet clips low similarities before scaling
        return self.gamma * sim


def DSSM(user_schema: FeatureSchema, item_schema: FeatureSchema, **kw) -> TwoTower:
    return TwoTower(user_schema, item_schema, use_senet=False, **kw)


def SENetDSSM(user_schema: FeatureSchema, item_schema: FeatureSchema, **kw) -> TwoTower:
    return TwoTower(user_schema, item_schema, use_senet=True, **kw)
