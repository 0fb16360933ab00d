"""Grouped stacked-vocabulary embedding tables and their lookup engines.

The schema's sparse fields are assigned round-robin to ``num_groups``
tables (default: one table per field), each addressed with per-field
offsets, as in the JAX package.  Tables here are LOGICAL ``(V_g, D)``:
the JAX package packs 128/D vocab rows into each physical row for the TPU's
128 lanes, a layout that buys nothing on the GPU, where a row gather reads
whole 32-byte sectors either way.  ``convert.params_from_jax`` unpacks.

On a (data, model) mesh a table whose rows the model axis divides holds
only this rank's row shard (``parallel/sharding_rules.py``), and its
lookups go through a sharded engine (``parallel/embedding_sharding.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from recsys_tpu_torch.core import spans
from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import embedding as emb_ops
from recsys_tpu_torch.parallel import embedding_sharding as es
from recsys_tpu_torch.parallel.mesh import MODEL_AXIS
from recsys_tpu_torch.parallel.sharding_rules import shard_count

ENGINES = ("gather", "psum", "dedup", "a2a", "a2a_pipelined")
INIT_BLOCK = 1 << 16  # table rows drawn from one generator at init


def uniform_rows(seed: int, lo: int, hi: int, cols: int, scale: float, dtype,
                 device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of a table drawn U[0, scale): block j of
    ``INIT_BLOCK`` rows from a generator on ``device`` seeded ``seed + j``,
    so a row shard draws the same values as the same rows of the whole
    table, without drawing the whole table."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    out = torch.empty((hi - lo, cols), dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    for j in range(lo // INIT_BLOCK, -(-hi // INIT_BLOCK)):
        a = j * INIT_BLOCK
        s, e = max(a, lo), min(a + INIT_BLOCK, hi)
        gen.manual_seed(seed + j)
        blk = torch.rand((min(INIT_BLOCK, e - a), cols), generator=gen, device=dev)
        out[s - lo:e - lo] = (blk[s - a:] * scale).to(dtype)
    return out


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
    CUDA tensor).  A schema may hold varlen fields only.  A table draws
    U[0, 0.05) (flax's ``uniform(scale=0.05)``) from a seed of its own
    drawn from torch's global generator (``uniform_rows``), so that a rank
    of a mesh draws only its row shard, the same rows as the whole table
    built with no mesh.

    ``perturb_out`` is the tap of the fused embedding optimizers (the JAX
    package's ``perturb_out``): when gradients are on and the tables are
    frozen (``requires_grad`` False, as ``Trainer`` sets them for a fused
    ``embedding_optimizer``), the gather runs outside autograd and its
    output becomes a leaf that requires grad, kept as ``self.tap``.  After
    ``backward`` its ``.grad`` is the per-occurrence (B, F, D) cotangent of
    the gathered rows, in the table dtype; no dense (V, D) table gradient
    is ever allocated.  ``forward`` runs inside the ``embedding.gather``
    span (``core/spans.py``).

    ``mesh`` (a ``parallel.mesh.Mesh``) builds each table whose rows the
    model axis divides as this rank's row shard only (``table_shards``,
    ``row_offset``); ``Trainer(mesh=)`` cuts a table built whole.
    ``engine`` picks the lookup of a sharded table
    (``parallel/embedding_sharding.py``): ``'psum'``, ``'dedup'``,
    ``'a2a'`` (the all-to-all id exchange at ``capacity_factor``, None the
    exact mode, ``a2a_dedup`` its dedup) and ``'a2a_pipelined'`` (in
    ``a2a_chunks`` chunks).  ``'gather'`` looks a table up in place, and a
    sharded one through the psum engine (what XLA's partitioner makes of
    the JAX package's gather).  An explicit engine also serves a table of a
    model axis of one (its one shard); a table that stays whole on a wider
    axis is looked up in place by every engine.  The a2a engines leave the
    global count of ids they dropped in ``self.dropped`` (an int32 device
    scalar, 0 after a forward with none), as the JAX engines sow it into
    ``'a2a_stats'``.
    """

    def __init__(self, schema: FeatureSchema, param_dtype=torch.float32,
                 num_groups: int | None = None, perturb_out: bool = False,
                 engine: str = "gather", mesh=None, capacity_factor: float | None = 2.0,
                 a2a_dedup: bool = True, a2a_chunks: int = 2, device=None):
        super().__init__()
        if engine not in ENGINES:
            raise ValueError(f"engine={engine!r} not in {ENGINES}")
        if engine != "gather" and mesh is None:
            raise ValueError(f"engine={engine!r} needs a mesh (pass the Trainer's)")
        self.schema = schema
        self.perturb_out = perturb_out
        self.engine, self.mesh = engine, mesh
        self.capacity_factor, self.a2a_dedup, self.a2a_chunks = (capacity_factor, a2a_dedup,
                                                                 a2a_chunks)
        self.tap = None
        self.dropped = None
        d = schema.embed_dim
        group_of, offset_in, group_vocab = group_assignment(schema, num_groups)
        self._group_of, self._offset_in = group_of, offset_in
        self.group_vocab = list(group_vocab)
        self.table_shards, self.row_offset = {}, {}
        for g, v in enumerate(group_vocab):
            rows = max(v, 1)
            seed = int(torch.randint(0, 1 << 62, (1,)))
            k = shard_count(rows, mesh)
            lo, hi = 0, rows
            # an explicit engine serves every table it can split, one shard
            # of a model axis of one included
            if mesh is not None and (k > 1 or (engine != "gather"
                                               and rows % mesh.size(MODEL_AXIS) == 0)):
                vs = rows // k
                lo = mesh.index(MODEL_AXIS) * vs if k > 1 else 0
                hi = lo + vs
                self.table_shards[g], self.row_offset[g] = k, lo
            t = uniform_rows(seed, lo, hi, d, 0.05, param_dtype, device)
            self.register_parameter(f"table_{g}", nn.Parameter(t))
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
        with spans.span("embedding.gather"):
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
        return self._fetch(g, ids.long() + self._offset_in[field_name])

    def _fetch(self, g: int, rows: torch.Tensor) -> torch.Tensor:
        """Rows ``rows`` (any shape) of group table ``g`` through the
        engine: rows.shape + (D,)."""
        t = self.table(g)
        if g not in self.table_shards:
            return emb_ops.gather(t, rows)
        if self.engine in ("gather", "psum"):
            return es.sharded_gather(t, rows, self.mesh)
        if self.engine == "dedup":
            return es.sharded_gather_dedup(t, rows, self.mesh)
        if self.engine == "a2a":
            out, dropped = es.sharded_gather_a2a(
                t, rows, self.mesh, capacity_factor=self.capacity_factor,
                dedup=self.a2a_dedup, return_stats=True)
        else:
            out, dropped = es.sharded_gather_a2a_pipelined(
                t, rows, self.mesh, num_chunks=self.a2a_chunks,
                capacity_factor=self.capacity_factor, dedup=self.a2a_dedup,
                return_stats=True)
        self.dropped = dropped if self.dropped is None else self.dropped + dropped
        return out

    def pooled_lookup(self, field_name: str, ids: torch.Tensor, mask: torch.Tensor,
                      mode: str = "mean") -> torch.Tensor:
        """Masked-pooled embedding (B, D) of a padded (B, L) id sequence:
        ``mode`` in sum, mean, sqrtn over the positions where ``mask`` is
        nonzero.  The tables are logical, so every field takes the
        pooled-gather route (the JAX package's packed tables gather and
        pool instead)."""
        g = self._group_of[field_name]
        if g in self.table_shards:  # a row shard: the engine's lookup, then the pool
            return emb_ops.pool(self.lookup(field_name, ids), mask, mode)
        rows = ids.to(torch.int32)
        off = self._offset_in[field_name]
        return dispatch.segment_sum_gather(self.table(g), rows + off if off else rows, mask,
                                           mode)

    def table_logical(self, field_name: str) -> torch.Tensor:
        """(V_group, D) table holding ``field_name`` (already logical)."""
        g = self._group_of[field_name]
        return self.table(g)[:self.group_vocab[g]]

    def field_offset(self, field_name: str) -> int:
        return self._offset_in[field_name]

    def _gather(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        self.dropped = None
        if not self._groups:
            return torch.zeros((sparse_ids.shape[0], 0, self.schema.embed_dim),
                               dtype=self.table(0).dtype, device=sparse_ids.device)
        parts = []
        for g in self._groups:  # a group's columns in one engine call
            rows = group_rows(self, g, sparse_ids)
            if g in self.table_shards:
                parts.append(self._fetch(g, rows))
                continue
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
        # set by parallel.sharding_rules.apply_param_shardings on a mesh
        self.mesh, self.table_shards, self.row_offset = None, {}, {}
        for g, v in enumerate(group_vocab):
            self.register_parameter(
                f"w_{g}", nn.Parameter(torch.zeros((max(v, 1), 1), device=device)))
        self._groups = sorted(register_group_columns(self, schema, group_of, offset_in, device))

    def forward(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        parts = []
        for g in self._groups:
            rows = group_rows(self, g, sparse_ids)
            w = getattr(self, f"w_{g}")
            if g in self.table_shards:  # a row shard: the psum lookup
                parts.append(es.sharded_gather(w, rows, self.mesh)[..., 0])
                continue
            parts.append(w.index_select(0, rows.reshape(-1)).reshape(rows.shape))
        if not parts:
            return torch.zeros(sparse_ids.shape[0], device=sparse_ids.device)
        return torch.cat(parts, dim=1).sum(dim=1)
