"""ESMM, the entire-space multi-task model (the port's copy of
``recsys_tpu/models/ctr/esmm.py``): one user tower and one item tower,
shared by a pCTR head and a pCVR head; pCTCVR = pCTR·pCVR.  Returns
*probabilities* {'ctr', 'cvr', 'ctcvr'}, each (B,): the heads train on
``ctr`` and ``ctcvr`` with ``losses.bce_probs``.

Batch: ``sparse`` (B, F), its first ``num_user_fields`` columns the user
side and the rest the item side; ``dense`` where the schema has dense
features.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.mlp import MLP


class ESMM(nn.Module):
    """``embedding``; ``user_mlp`` and ``item_mlp`` the shared relu towers;
    ``ctr_head`` and ``cvr_head`` the ``head_units`` towers to one logit
    each, over [user, item, dense]."""

    def __init__(self, schema: FeatureSchema, num_user_fields: int,
                 user_units: Sequence[int] = (128, 64), item_units: Sequence[int] = (128, 64),
                 head_units: Sequence[int] = (64, 32), dropout_rate: float = 0.0,
                 embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.num_user_fields = num_user_fields
        d = schema.embed_dim
        self.embedding = StackedEmbedding(schema, device=device, **(embed_kw or {}))
        self.user_mlp = MLP(num_user_fields * d, user_units, dropout_rate=dropout_rate,
                            device=device)
        self.item_mlp = MLP((schema.num_sparse - num_user_fields) * d, item_units,
                            dropout_rate=dropout_rate, device=device)
        head_in = user_units[-1] + item_units[-1] + schema.num_dense
        self.ctr_head, self.cvr_head = (
            MLP(head_in, head_units, out_dim=1, dropout_rate=dropout_rate, device=device)
            for _ in range(2))

    def forward(self, batch: dict) -> dict:
        sparse = batch["sparse"]
        field_embs = self.embedding(sparse)  # (B, F, D)
        b, nu = sparse.shape[0], self.num_user_fields
        parts = [self.user_mlp(field_embs[:, :nu].reshape(b, -1)),
                 self.item_mlp(field_embs[:, nu:].reshape(b, -1))]
        if self.schema.num_dense:
            parts.append(batch["dense"])
        x = torch.cat(parts, dim=-1)
        p_ctr = torch.sigmoid(self.ctr_head(x)[..., 0])
        p_cvr = torch.sigmoid(self.cvr_head(x)[..., 0])
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}
