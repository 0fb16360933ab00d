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
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import embedding as emb_ops


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


def register_group_columns(module: nn.Module, schema: FeatureSchema, group_of: dict,
                           offset_in: dict, device=None) -> dict[int, list[int]]:
    """Register on ``module``, for each group table that serves sparse
    columns, the buffers ``cols_{g}`` (the id columns it serves) and
    ``offs_{g}`` (their offsets in it); returns {g: columns}."""
    by_group: dict[int, list[int]] = {}
    for j, f in enumerate(schema.sparse):
        by_group.setdefault(group_of[f.name], []).append(j)
    for g, js in by_group.items():
        offs = [offset_in[schema.sparse[j].name] for j in js]
        module.register_buffer(f"cols_{g}", torch.tensor(js, device=device), persistent=False)
        module.register_buffer(f"offs_{g}", torch.tensor(offs, device=device), persistent=False)
    return by_group


def group_rows(module: nn.Module, g: int, sparse_ids: torch.Tensor) -> torch.Tensor:
    """(B, F) field-local ids -> the (B, F_g) rows of group table ``g``."""
    rows = sparse_ids.index_select(1, getattr(module, f"cols_{g}")).long()
    return rows + getattr(module, f"offs_{g}")


class StackedEmbedding(nn.Module):
    """Grouped embedding tables behind a stacked-offset API.

    ``forward`` takes field-local IDs shaped (B, F) ordered like
    ``schema.sparse`` and returns (B, F, D) in ``param_dtype``.  Table ``g``
    is the parameter ``table_{g}``, shaped (V_g, D).  ``lookup`` embeds ids
    of any shape for one named field (sparse or varlen) and
    ``pooled_lookup`` pools a padded (B, L) id sequence of one field
    through ``dispatch.segment_sum_gather`` (the pooled-gather kernel on a
    CUDA tensor).  A schema may hold varlen fields only.

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
        self._group_of, self._offset_in = group_of, offset_in
        self.group_vocab = list(group_vocab)
        for g, v in enumerate(group_vocab):
            # U[0, 0.05): what flax's uniform(scale=0.05) in the JAX package draws
            t = torch.empty((max(v, 1), d), dtype=param_dtype, device=device)
            self.register_parameter(f"table_{g}", nn.Parameter(t.uniform_(0.0, 0.05)))
        by_group = register_group_columns(self, schema, group_of, offset_in, device)
        self._groups = sorted(by_group)
        # output position of each group's columns, to undo the grouping
        order = np.concatenate([by_group[g] for g in self._groups] or [np.zeros(0, int)])
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

    def lookup(self, field_name: str, ids: torch.Tensor) -> torch.Tensor:
        """Embed ``ids`` (any shape) from ``field_name``'s table slice."""
        g = self._group_of[field_name]
        return emb_ops.gather(self.table(g), ids.long() + self._offset_in[field_name])

    def pooled_lookup(self, field_name: str, ids: torch.Tensor, mask: torch.Tensor,
                      mode: str = "mean") -> torch.Tensor:
        """Masked-pooled embedding (B, D) of a padded (B, L) id sequence:
        ``mode`` in sum, mean, sqrtn over the positions where ``mask`` is
        nonzero.  The tables are logical, so every field takes the
        pooled-gather route (the JAX package's packed tables gather and
        pool instead)."""
        rows = ids.to(torch.int32)
        off = self._offset_in[field_name]
        return dispatch.segment_sum_gather(self.table(self._group_of[field_name]),
                                           rows + off if off else rows, mask, mode)

    def table_logical(self, field_name: str) -> torch.Tensor:
        """(V_group, D) table holding ``field_name`` (already logical)."""
        g = self._group_of[field_name]
        return self.table(g)[:self.group_vocab[g]]

    def field_offset(self, field_name: str) -> int:
        return self._offset_in[field_name]

    def _gather(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        if not self._groups:
            return torch.zeros((sparse_ids.shape[0], 0, self.schema.embed_dim),
                               dtype=self.table(0).dtype, device=sparse_ids.device)
        parts = []
        for g in self._groups:
            rows = group_rows(self, g, sparse_ids)
            emb = self.table(g).index_select(0, rows.reshape(-1))
            parts.append(emb.reshape(*rows.shape, -1))
        out = torch.cat(parts, dim=1)
        return out if self._in_order else out.index_select(1, self.unperm)


class SparseLinear(nn.Module):
    """Per-id first-order weights: ``Σ_f w[id_f]`` over a batch's sparse ids,
    the FM first-order term of one-hot categorical inputs without the
    one-hot.  Grouped like ``StackedEmbedding`` (default one group per
    field): group ``g``'s weights are the parameter ``w_{g}``, a LOGICAL
    ``(V_g, 1)`` table (the JAX package packs them 128 to a physical row;
    ``convert`` unpacks), read with plain gathers.  Initialised to zero.

    ``forward`` takes (B, F) field-local ids ordered like ``schema.sparse``
    and returns (B,) f32."""

    def __init__(self, schema: FeatureSchema, num_groups: int | None = None, device=None):
        super().__init__()
        group_of, offset_in, group_vocab = group_assignment(schema, num_groups)
        self.group_vocab = list(group_vocab)
        for g, v in enumerate(group_vocab):
            self.register_parameter(
                f"w_{g}", nn.Parameter(torch.zeros((max(v, 1), 1), device=device)))
        self._groups = sorted(register_group_columns(self, schema, group_of, offset_in, device))

    def forward(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        parts = []
        for g in self._groups:
            rows = group_rows(self, g, sparse_ids)
            w = getattr(self, f"w_{g}")
            parts.append(w.index_select(0, rows.reshape(-1)).reshape(rows.shape))
        if not parts:
            return torch.zeros(sparse_ids.shape[0], device=sparse_ids.device)
        return torch.cat(parts, dim=1).sum(dim=1)
