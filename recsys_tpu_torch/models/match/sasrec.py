"""SASRec: self-attentive sequential recommendation (the port's copy of
``recsys_tpu/models/match/sasrec.py``).

An item-id history, padded in front with ``pad_id``, goes through the item
table (scaled by sqrt(D)), learned positional embeddings and
``num_blocks`` transformer blocks with a key-padding mask; pad positions
are zeroed after the embedding and after every block.  The last position's
state is the user vector.  Attention runs through the flash kernels on a
CUDA tensor (``ops/attention.py``).

``forward`` returns {'pos_logits', 'neg_logits'} (and a 'mask' in the
all-position scheme); training uses ``train.losses.pairwise_bce``, serving
ranks the positive among its negatives (``train.metrics.hit_rate_ndcg_at_k``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.ops.attention import PositionalEmbedding, TransformerBlock


class SASRec(nn.Module):
    """``num_items`` counts the pad id 0; the item table is logical
    (num_items, embed_dim) f32.  ``causal`` (the published model) masks
    later positions; the all-position scheme needs it."""

    def __init__(self, num_items: int, embed_dim: int = 64, num_blocks: int = 2,
                 num_heads: int = 1, ffn_dim: int | None = None, max_len: int = 50,
                 dropout_rate: float = 0.2, pad_id: int = 0, causal: bool = True,
                 device=None):
        super().__init__()
        self.num_items = num_items
        # item-id inputs, checked by Trainer
        self.id_vocabs = dict.fromkeys(("hist", "pos", "neg"), num_items)
        self.embed_dim = embed_dim
        self.pad_id = pad_id
        self.item_table = nn.Parameter(
            torch.randn(num_items, embed_dim, device=device) * 0.05)
        self.pos_emb = PositionalEmbedding(max_len, embed_dim, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads=num_heads, ffn_dim=ffn_dim,
                             dropout_rate=dropout_rate, causal=causal, device=device)
            for _ in range(num_blocks))

    def item_embed(self, item_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(item_ids, self.item_table)

    def all_item_embeddings(self) -> torch.Tensor:
        return self.item_table

    def encode_all(self, hist: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> every position's encoder state (B, L, D)."""
        mask = hist != self.pad_id  # (B, L) key-padding mask
        keep = mask[..., None].to(self.item_table.dtype)
        x = self.item_embed(hist) * math.sqrt(self.embed_dim)
        x = self.pos_emb(x) * keep
        for block in self.blocks:
            x = block(x, mask) * keep
        return x

    def encode(self, hist: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the user vector (B, D): the last (newest) position."""
        return self.encode_all(hist)[:, -1, :]

    def forward(self, batch: dict) -> dict:
        """Two schemes, chosen by the shape of ``batch['pos']``:

        * pos (B,), neg (B, N): the prefix scheme, one prediction per row
          from the last position.
        * pos (B, L), neg (B, L): the all-position scheme; position t
          predicts pos[t] against neg[t], and 'mask' (B, L) marks the
          positions with a target."""
        if batch["pos"].dim() == 2:
            states = self.encode_all(batch["hist"])
            return {
                "pos_logits": (states * self.item_embed(batch["pos"])).sum(-1),
                "neg_logits": (states * self.item_embed(batch["neg"])).sum(-1)[..., None],
                "mask": batch["pos"] != self.pad_id,
            }
        user = self.encode(batch["hist"])
        pos = self.item_embed(batch["pos"])
        neg = self.item_embed(batch["neg"])
        return {"pos_logits": (user * pos).sum(-1),
                "neg_logits": torch.einsum("bd,bnd->bn", user, neg)}
