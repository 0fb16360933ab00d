"""Grouped stacked-vocabulary embedding tables (``gather`` engine).

The schema's sparse fields are assigned round-robin to ``num_groups``
tables (default: one table per field), each addressed with per-field
offsets, as in the JAX package.  Tables here are LOGICAL ``(V_g, D)``:
the JAX package packs 128/D vocab rows into each physical row for the TPU's
128 lanes, a layout that buys nothing on the GPU, where a row gather reads
whole 32-byte sectors either way.  ``convert.params_from_jax`` unpacks.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from recsys_tpu_torch.core.features import FeatureSchema


def group_assignment(schema: FeatureSchema, num_groups: int | None):
    """Assign owner fields (sparse + non-shared varlen) to group tables.

    Returns (group_of: {field: g}, offset_in_group: {field: off},
    group_vocab: [V_g]).  Fields are assigned round-robin in schema order;
    shared varlen fields inherit their owner's slot.
    """
    owners = list(schema.sparse) + [
        f for f in schema.varlen if f.shared_with is None
    ]
    n = len(owners)
    g_count = n if num_groups is None else max(1, min(num_groups, n))
    group_of: dict[str, int] = {}
    offset_in: dict[str, int] = {}
    group_vocab = [0] * g_count
    for i, f in enumerate(owners):
        g = i % g_count
        group_of[f.name] = g
        offset_in[f.name] = group_vocab[g]
        group_vocab[g] += f.vocab_size
    for f in schema.varlen:
        if f.shared_with is not None:
            group_of[f.name] = group_of[f.shared_with]
            offset_in[f.name] = offset_in[f.shared_with]
    return group_of, offset_in, group_vocab


class StackedEmbedding(nn.Module):
    """Grouped embedding tables behind a stacked-offset API.

    ``forward`` takes field-local IDs shaped (B, F) ordered like
    ``schema.sparse`` and returns (B, F, D) in ``param_dtype``.  Table ``g``
    is the parameter ``table_{g}``, shaped (V_g, D).

    ``perturb_out`` is the tap of the fused embedding optimizers (the JAX
    package's ``perturb_out``): when gradients are on and the tables are
    frozen (``requires_grad`` False, as ``Trainer`` sets them for a fused
    ``embedding_optimizer``), the gather runs outside autograd and its
    output becomes a leaf that requires grad, kept as ``self.tap``.  After
    ``backward`` its ``.grad`` is the per-occurrence (B, F, D) cotangent of
    the gathered rows, in the table dtype; no dense (V, D) table gradient
    is ever allocated.
    """

    def __init__(self, schema: FeatureSchema, param_dtype=torch.float32,
                 num_groups: int | None = None, perturb_out: bool = False,
                 device=None):
        super().__init__()
        self.schema = schema
        self.perturb_out = perturb_out
        self.tap = None
        d = schema.embed_dim
        group_of, offset_in, group_vocab = group_assignment(schema, num_groups)
        self.group_vocab = list(group_vocab)
        for g, v in enumerate(group_vocab):
            # uniform(-0.05, 0.05), the Keras Embedding default
            t = torch.empty((max(v, 1), d), dtype=param_dtype, device=device)
            self.register_parameter(f"table_{g}", nn.Parameter(t.uniform_(-0.05, 0.05)))
        # per group: which id columns it serves and their offsets in it
        by_group: dict[int, list[int]] = {}
        for j, f in enumerate(schema.sparse):
            by_group.setdefault(group_of[f.name], []).append(j)
        self._groups = sorted(by_group)
        for g in self._groups:
            js = by_group[g]
            offs = [offset_in[schema.sparse[j].name] for j in js]
            self.register_buffer(f"cols_{g}", torch.tensor(js, device=device),
                                 persistent=False)
            self.register_buffer(f"offs_{g}", torch.tensor(offs, device=device),
                                 persistent=False)
        # output position of each group's columns, to undo the grouping
        order = np.concatenate([by_group[g] for g in self._groups])
        self._in_order = bool((order == np.arange(len(order))).all())
        self.register_buffer("unperm", torch.as_tensor(np.argsort(order),
                                                       device=device),
                             persistent=False)

    def table(self, g: int) -> torch.Tensor:
        return getattr(self, f"table_{g}")

    def groups(self) -> list[int]:
        """The group tables that serve at least one sparse column."""
        return list(self._groups)

    def forward(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        tapped = (self.perturb_out and torch.is_grad_enabled()
                  and not any(self.table(g).requires_grad for g in self._groups))
        if tapped:
            with torch.no_grad():
                out = self._gather(sparse_ids)
            self.tap = out.requires_grad_()
            return out
        return self._gather(sparse_ids)

    def _gather(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        parts = []
        for g in self._groups:
            rows = sparse_ids.index_select(1, getattr(self, f"cols_{g}")).long()
            rows = rows + getattr(self, f"offs_{g}")
            emb = self.table(g).index_select(0, rows.reshape(-1))
            parts.append(emb.reshape(*rows.shape, -1))
        out = torch.cat(parts, dim=1)
        return out if self._in_order else out.index_select(1, self.unperm)
