"""Parameter sharding rules for the (data, model) mesh (the port of
``recsys_tpu/parallel/sharding_rules.py``).

A table of a ``StackedEmbedding`` or ``SparseLinear`` (``table_{g}``,
``w_{g}``) is row-sharded over the ``model`` axis when the axis divides its
row count; every other parameter is replicated.  The JAX package pads its
physical rows to a multiple of 8, so its tables always split; the port's
logical (V, D) tables split where V allows, and a table that does not
stays whole on every rank and is looked up locally, as the sum over one
shard would give.

A sharded table module keeps ``mesh``, ``table_shards`` {g: shard count}
and ``row_offset`` {g: its first global row}; a rank's shard is rows
``[row_offset, row_offset + V / shards)``.
"""
from __future__ import annotations

import torch

from recsys_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

TABLE_PREFIX = {"StackedEmbedding": "table_", "SparseLinear": "w_"}


def table_modules(model: torch.nn.Module):
    """(qualified name, module, parameter prefix) of every table module."""
    for name, mod in model.named_modules():
        prefix = TABLE_PREFIX.get(type(mod).__name__)
        if prefix is not None:
            yield name, mod, prefix


def shard_count(rows: int, mesh: Mesh | None) -> int:
    """Model shards of a table of ``rows`` rows: the model axis where it
    divides them, else 1."""
    n = 1 if mesh is None else mesh.size(MODEL_AXIS)
    return n if n > 1 and rows % n == 0 else 1


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """{parameter name: MODEL_AXIS for a row-sharded table, None for a
    replicated parameter}, by the global row counts."""
    out = {name: None for name, _ in model.named_parameters()}
    for qual, mod, prefix in table_modules(model):
        for g, rows in enumerate(mod.group_vocab):
            if shard_count(max(rows, 1), mesh) > 1:
                out[f"{qual}.{prefix}{g}" if qual else f"{prefix}{g}"] = MODEL_AXIS
    return out


def shard_state(state: dict, model: torch.nn.Module, mesh: Mesh) -> dict:
    """A full (unsharded) state dict, as ``convert``'s ``*_from_jax``
    functions give it, cut to this rank's: each row-sharded table's rows of
    its model shard, everything else whole.  Load it into a model built
    with ``mesh`` (its tables built into their shards)."""
    n, s = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    out = dict(state)
    for name, axis in param_shardings(model, mesh).items():
        if axis is not None and name in state:
            vs = state[name].shape[0] // n
            out[name] = state[name][s * vs:(s + 1) * vs]
    return out


def apply_param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Give each table module on ``model`` this rank's rows: a table built
    whole is cut to its shard (a table built into its shard is left as it
    is), and each module records ``mesh``, ``table_shards`` and
    ``row_offset``.  Returns {parameter name: shard count} of every table."""
    n, s = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    counts = {}
    for qual, mod, prefix in table_modules(model):
        mod.mesh = mesh
        for g, rows in enumerate(mod.group_vocab):
            rows = max(rows, 1)
            k = shard_count(rows, mesh)
            name = f"{prefix}{g}"
            counts[f"{qual}.{name}" if qual else name] = k
            if k == 1 or mod.table_shards.get(g, 1) == k:
                continue
            param = getattr(mod, name)
            vs = rows // k
            with torch.no_grad():
                param.data = param.data[s * vs:(s + 1) * vs].clone()
            mod.table_shards[g], mod.row_offset[g] = k, s * vs
    return counts
