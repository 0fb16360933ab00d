"""NCF, the NeuMF model (the port's copy of
``recsys_tpu/models/match/ncf.py``): a GMF branch (the elementwise product
of a user and an item embedding) and an MLP branch over the concatenation
of two other embeddings, joined by one linear head; trained with the
pairwise BCE over sampled negatives and ranked among 100 negatives.

Batch: {'user': (B,), 'pos_item': (B,), 'neg_item': (B, N)}.  ``forward``
returns {'pos_logits': (B,), 'neg_logits': (B, N)}; ``score`` scores any
(user, items) pairs.  The four tables are plain gathers: the JAX module
reaches no Pallas kernel either.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.kernels.embedding import gather
from recsys_tpu_torch.ops.init import dense_init_
from recsys_tpu_torch.ops.mlp import MLP


class NCF(nn.Module):
    """Tables ``user_gmf``, ``item_gmf`` (gmf_dim wide), ``user_mlp`` and
    ``item_mlp`` (mlp_dim wide), each drawn N(0, 0.05²) as flax's
    ``normal(0.05)``; ``mlp`` the relu tower ``mlp_units`` over the
    concatenated MLP embeddings; ``head`` the linear layer over [gmf,
    mlp]."""

    def __init__(self, num_users: int, num_items: int, gmf_dim: int = 32, mlp_dim: int = 32,
                 mlp_units: Sequence[int] = (64, 32, 16), dropout_rate: float = 0.0,
                 device=None):
        super().__init__()
        self.num_users, self.num_items = num_users, num_items
        # id inputs, checked by Trainer against their tables
        self.id_vocabs = {"user": num_users, "pos_item": num_items, "neg_item": num_items}

        def table(rows, dim):
            return nn.Parameter(torch.randn(rows, dim, device=device) * 0.05)

        self.user_gmf, self.item_gmf = table(num_users, gmf_dim), table(num_items, gmf_dim)
        self.user_mlp, self.item_mlp = table(num_users, mlp_dim), table(num_items, mlp_dim)
        self.mlp = MLP(2 * mlp_dim, mlp_units, dropout_rate=dropout_rate, device=device)
        self.head = dense_init_(nn.Linear(gmf_dim + mlp_units[-1], 1, device=device))

    def score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """users (B,), items (B,) or (B, N) -> logits of the items' shape."""
        items2 = items[:, None] if items.dim() == 1 else items  # (B, N)
        b, n = items2.shape
        ug = gather(self.user_gmf, users)[:, None, :]  # (B, 1, D)
        um = gather(self.user_mlp, users)[:, None, :]
        ig = gather(self.item_gmf, items2)  # (B, N, D)
        im = gather(self.item_mlp, items2)
        mlp_in = torch.cat([um.expand_as(im), im], dim=-1)
        mlp_out = self.mlp(mlp_in.reshape(b * n, -1)).reshape(b, n, -1)
        logits = self.head(torch.cat([ug * ig, mlp_out], dim=-1))[..., 0]  # (B, N)
        return logits[:, 0] if items.dim() == 1 else logits

    def forward(self, batch: dict) -> dict:
        return {"pos_logits": self.score(batch["user"], batch["pos_item"]),
                "neg_logits": self.score(batch["user"], batch["neg_item"])}
