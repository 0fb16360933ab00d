"""DIN, target attention over a padded behaviour sequence (the port's copy
of ``recsys_tpu/models/ctr/din.py``): the candidate item queries the
history, padding masked, and the softmax-weighted history joins the field
embeddings in an FFN with PReLU or Dice.

Batch: ``sparse`` (B, F), column ``target_index`` the candidate item and,
with the category stream, column ``target_index + 1`` its category;
``hist`` (B, L) history item ids padded with the varlen field's
``pad_id``; ``hist_cate`` (B, L) their categories, read when the schema has
the ``hist_cate_field`` (the Amazon protocol's builders emit both); and
``dense`` where the schema has dense features.  With the category stream
the keys and the query are [item; category] embeddings.  The history goes
through ``StackedEmbedding.lookup`` of the fields it shares its tables
with: plain gathers, as in the JAX module.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.attention import Dropout, TargetAttention
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.init import dense_init_
from recsys_tpu_torch.ops.mlp import BatchNorm, Dice, PReLU


class DIN(nn.Module):
    """``embedding`` the shared tables, ``attention`` the target attention
    (``att_hidden_units``), ``bn`` the entry BatchNorm over the
    concatenation, then ``ffn`` (the ``ffn_hidden_units`` layers and the
    final logit) with ``acts`` (a ``PReLU`` or, for ``ffn_activation=
    'dice'``, a ``Dice`` after each hidden layer).  Returns (B,) logits."""

    def __init__(self, schema: FeatureSchema, hist_field: str = "hist_item",
                 hist_cate_field: str = "hist_cate", target_index: int = 0,
                 att_hidden_units: Sequence[int] = (32, 16),
                 ffn_hidden_units: Sequence[int] = (80, 40), ffn_activation: str = "prelu",
                 dropout_rate: float = 0.0, embed_kw: dict | None = None, device=None):
        super().__init__()
        self.schema = schema
        self.hist_field, self.hist_cate_field = hist_field, hist_cate_field
        self.target_index = target_index
        self.use_cate = any(f.name == hist_cate_field for f in schema.varlen)
        self.pad_id = schema.field(hist_field).pad_id
        # history ids, checked by Trainer against the tables they index
        self.id_vocabs = {"hist": schema.field(hist_field).vocab_size}
        if self.use_cate:
            self.id_vocabs["hist_cate"] = schema.field(hist_cate_field).vocab_size
        d = schema.embed_dim
        att_dim = 2 * d if self.use_cate else d
        self.embedding = StackedEmbedding(schema, device=device, **(embed_kw or {}))
        self.attention = TargetAttention(att_dim, att_hidden_units, device=device)
        in_dim = schema.num_sparse * d + att_dim + schema.num_dense
        self.bn = BatchNorm(in_dim, device=device)
        dims = [in_dim, *ffn_hidden_units, 1]
        self.ffn = nn.ModuleList(dense_init_(nn.Linear(a, b, device=device))
                                 for a, b in zip(dims, dims[1:]))
        act = Dice if ffn_activation == "dice" else PReLU
        self.acts = nn.ModuleList(act(w, device=device) for w in ffn_hidden_units)
        self.drops = nn.ModuleList(Dropout(dropout_rate) for _ in ffn_hidden_units) \
            if dropout_rate > 0.0 else None

    def forward(self, batch: dict) -> torch.Tensor:
        sparse, hist = batch["sparse"], batch["hist"]
        field_embs = self.embedding(sparse)  # (B, F, D)
        target = field_embs[:, self.target_index, :]
        keys = self.embedding.lookup(self.hist_field, hist)  # (B, L, D)
        if self.use_cate:
            keys = torch.cat([keys, self.embedding.lookup(self.hist_cate_field,
                                                          batch["hist_cate"])], dim=-1)
            target = torch.cat([target, field_embs[:, self.target_index + 1, :]], dim=-1)
        pooled = self.attention(target, keys, hist != self.pad_id)
        parts = [field_embs.reshape(sparse.shape[0], -1), pooled]
        if self.schema.num_dense:
            parts.append(batch["dense"])
        x = self.bn(torch.cat(parts, dim=-1))
        for i, act in enumerate(self.acts):
            x = act(self.ffn[i](x))
            if self.drops is not None:
                x = self.drops[i](x)
        return self.ffn[-1](x)[..., 0]
