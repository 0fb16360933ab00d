"""DLRM (Naumov et al. 2019): bottom MLP over dense, pairwise dot
interaction, top MLP.

  z = bottom_mlp(dense)                      (B, D)
  E = field embeddings                       (B, F, D)
  I = pairwise dots of [z, E]                (B, (F+1)F/2)
  logit = top_mlp([z, I])

The dot interaction runs through the CUDA kernel on a CUDA tensor, with
its backward in torch ops (``dispatch.DotInteraction``).  The
casts repeat the JAX package's DLRM exactly: field embeddings in the compute
dtype, the bottom output cast to the field dtype for the concat, the dot
output in f32, ``top_in`` concatenated in f32 and the logits returned f32.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels.interactions import num_pairs
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.mlp import MLP, FusedMLP


class DLRM(nn.Module):
    """``compute_dtype`` (e.g. ``torch.bfloat16``) runs the MLPs and the
    interaction in that type while params stay f32; ``fused_mlps`` routes
    both towers through the fused MLP kernel; ``dense_microbatch`` runs the
    dense tail as N slices of the batch while the embedding gather stays
    whole-batch (a batch that N does not divide runs unsliced);
    ``sparse_embed_grads`` turns on the tables' ``perturb_out`` tap, which
    the fused embedding optimizers of ``Trainer`` need;
    ``embed_kw`` passes ``param_dtype`` / ``num_groups`` to the tables."""

    def __init__(self, schema: FeatureSchema,
                 bottom_units: Sequence[int] = (256, 64),
                 top_units: Sequence[int] = (256, 128, 64),
                 self_interaction: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 fused_mlps: bool = False,
                 dense_microbatch: int = 1,
                 sparse_embed_grads: bool = False,
                 embed_kw: dict | None = None,
                 device=None):
        super().__init__()
        self.schema = schema
        self.self_interaction = self_interaction
        self.compute_dtype = compute_dtype
        self.dense_microbatch = dense_microbatch
        d = schema.embed_dim
        self.embedding = StackedEmbedding(schema, perturb_out=sparse_embed_grads,
                                          device=device, **(embed_kw or {}))

        def make_mlp(in_dim, units, out_dim):
            if fused_mlps:
                return FusedMLP(in_dim, units, out_dim,
                                mm_bf16=compute_dtype is not None, device=device)
            return MLP(in_dim, units, out_dim=out_dim, dtype=compute_dtype,
                       device=device)

        self.has_dense = schema.num_dense > 0
        n_fields = schema.num_sparse + int(self.has_dense)
        top_in = num_pairs(n_fields, self_interaction) + (d if self.has_dense else 0)
        self.bottom = make_mlp(schema.num_dense, bottom_units, d) if self.has_dense else None
        self.top = make_mlp(top_in, top_units, 1)

    def _tail(self, dense, field_embs):
        feats, bottom = field_embs, None
        if self.has_dense:
            bottom = self.bottom(dense)
            feats = torch.cat([bottom[:, None, :].to(field_embs.dtype), field_embs], dim=1)
        inter = dispatch.DotInteraction.apply(feats.contiguous(), self.self_interaction)
        top_in = inter if bottom is None else torch.cat(
            [bottom.to(inter.dtype), inter], dim=-1
        )
        return self.top(top_in)[..., 0]

    def forward(self, batch: dict) -> torch.Tensor:
        sparse, dense = batch["sparse"], batch.get("dense")
        field_embs = self.embedding(sparse)
        if self.compute_dtype is not None:
            field_embs = field_embs.to(self.compute_dtype)
        nm, b = self.dense_microbatch, sparse.shape[0]
        if nm <= 1 or b % nm:
            logits = self._tail(dense, field_embs)
        else:
            # the slices share the towers (one param set); the gather above
            # stays whole-batch
            bs = b // nm
            logits = torch.cat([
                self._tail(
                    dense[i * bs:(i + 1) * bs] if self.has_dense else None,
                    field_embs[i * bs:(i + 1) * bs],
                )
                for i in range(nm)
            ])
        return logits.float()
