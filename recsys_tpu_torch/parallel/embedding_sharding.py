"""Row-sharded embedding lookups over the ``model`` axis of a mesh (the
port of ``recsys_tpu/parallel/embedding_sharding.py``).

Each engine runs on one rank: ``table`` is this rank's shard, rows
``[s·V_local, (s+1)·V_local)`` of the global table for model index s,
``rows`` the global row ids of this rank's data shard (any shape), and the
result ``rows.shape + (D,)`` is the lookup, replicated over the model axis.
Gradients reach the shard through autograd: each rank's shard gradient is
its rows' part of its data shard's scatter-add, never a multiple of it;
``Trainer`` then sums each shard's gradient over the data ranks that hold
it.  (In the a2a engines every rank of a model group exchanges the same
ids, so each of those S lookups passes on 1/S of its gradient.)  Negative ids are padding: a zero vector, no capacity used.

* ``sharded_gather`` (psum): a masked local gather, summed over ``model``.
* ``sharded_gather_dedup``: the same over each rank's unique ids.
* ``sharded_gather_a2a``: ids bucketed by owner at a static capacity,
  exchanged with an equal-split ``all_to_all_single``, gathered by their
  owners and sent back; ids past an owner's capacity are dropped (zero
  vectors) and counted, the count summed over ``data``.
* ``sharded_gather_a2a_pipelined``: the a2a engine in ``num_chunks``
  chunks, every chunk's id exchange issued at once, so that chunk k's
  return exchange runs while chunk k+1's ids are in flight.
* ``sharded_gather_cols``: a column-sharded table, gathered locally and
  all-gathered along D.

The capacities are the JAX engines' own, so every exchange has equal
splits.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, AllGatherCols,
                                            AllReduceSum, AllToAll, Mesh, all_reduce,
                                            all_to_all, pad_to_multiple)


def shard_table(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's row shard of a (V, D) table (V divisible by the model
    axis)."""
    n, s = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} rows do not split over a model axis of {n}")
    vs = table.shape[0] // n
    return table[s * vs:(s + 1) * vs]


def _local_rows(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh):
    """(rows made local to this shard, clamped into it, the hit mask)."""
    v_local = table.shape[0]
    local = rows.long() - mesh.index(MODEL_AXIS) * v_local
    hit = (local >= 0) & (local < v_local)
    return torch.where(hit, local, 0), hit


def _masked_take(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    safe, hit = _local_rows(table, rows, mesh)
    emb = table.index_select(0, safe.reshape(-1)).reshape(*rows.shape, table.shape[1])
    return emb * hit[..., None].to(emb.dtype)


def sharded_gather(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Lookup of ``rows`` in the row-sharded ``table``: each global row
    lives on one shard, so the sum of the masked local gathers over the
    model axis is the lookup."""
    return AllReduceSum.apply(_masked_take(table, rows, mesh), mesh, MODEL_AXIS)


def sharded_gather_dedup(table: torch.Tensor, rows: torch.Tensor,
                         mesh: Mesh) -> torch.Tensor:
    """``sharded_gather`` of each rank's unique ids, expanded after the sum:
    the local gather (and its backward scatter-add) touches each unique
    row once."""
    uniq, inv = unique_with_counts_static(rows.reshape(-1))
    emb = AllReduceSum.apply(_masked_take(table, uniq, mesh), mesh, MODEL_AXIS)
    return emb.index_select(0, inv).reshape(*rows.shape, table.shape[1])


# -- a2a building blocks (shared by the single-shot and pipelined engines) --

def _a2a_bucket(ids: torch.Tensor, v_local: int, n_model: int, cap: int):
    """Owner-bucket one chunk's ids -> (send (S·C,) int32, undo state,
    dropped).  Slot value 0 means "no id" (ids are sent +1); ids past an
    owner's capacity are not sent and come back as zero vectors; negative
    ids are padding: no owner, no capacity, zero vectors.  ``dropped``
    counts the real ids this rank could not send."""
    n = ids.shape[0]
    owner = torch.where(ids >= 0, ids // v_local, n_model)
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    counts = torch.bincount(owner, minlength=n_model + 1)[:n_model]
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=ids.device) - group_start[sorted_owner.clamp(max=n_model - 1)]
    real = sorted_owner < n_model
    keep = real & (pos < cap)
    send = torch.zeros(n_model * cap, dtype=torch.int32, device=ids.device)
    send[(sorted_owner * cap + pos)[keep]] = (ids[order][keep] + 1).to(torch.int32)
    dropped = (real & (pos >= cap)).sum().to(torch.int32)
    return send, (order, sorted_owner, pos), dropped


def _a2a_serve(table: torch.Tensor, recv: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This shard's rows for the received requests (zero at an empty slot)."""
    valid = recv > 0
    rows = torch.where(valid, recv.long() - 1, -1)
    safe, hit = _local_rows(table, rows, mesh)
    return table.index_select(0, safe) * (valid & hit)[:, None].to(table.dtype)


def _a2a_unbucket(back: torch.Tensor, state, n_model: int, cap: int) -> torch.Tensor:
    """Undo the owner sort; zero the dropped and padding slots."""
    order, sorted_owner, pos = state
    slot = (sorted_owner * cap + pos).clamp(0, n_model * cap - 1)
    dead = (pos >= cap) | (sorted_owner >= n_model)
    got = back.index_select(0, slot) * (~dead)[:, None].to(back.dtype)
    return got.index_select(0, torch.argsort(order))


def a2a_capacity(n: int, n_model: int, capacity_factor: float | None) -> int:
    """Owner-bucket slots for an n-id exchange: ``ceil(n / S · cf)``, or n
    in the exact mode (``capacity_factor=None``: nothing can drop)."""
    if capacity_factor is None:
        return n
    return min(n, int(np.ceil(n / n_model * capacity_factor)))


def _exchange(table: torch.Tensor, chunks: list, mesh: Mesh, cap: int) -> tuple:
    """The a2a lookups of ``chunks`` (1-D id tensors of one length): every
    chunk's id exchange issued first, then chunk by chunk the owners'
    gather and the vectors' return.  Returns (vectors a chunk, dropped)."""
    n_model = mesh.size(MODEL_AXIS)
    sends, states, dropped = [], [], 0
    for ids in chunks:
        send, st, drop = _a2a_bucket(ids, table.shape[0], n_model, cap)
        sends.append(send)
        states.append(st)
        dropped = dropped + drop
    recvs = [all_to_all(send, mesh, MODEL_AXIS, async_op=True) for send in sends]
    outs = []
    for (recv, wait), st in zip(recvs, states):
        wait()
        emb = _a2a_serve(table, recv, mesh)
        back = AllToAll.apply(emb, mesh, MODEL_AXIS)
        outs.append(_a2a_unbucket(back, st, n_model, cap))
    return outs, dropped


class _ReplicaShare(torch.autograd.Function):
    """Identity forward; backward ``g / S``.  Every rank of a model group
    looks up the same ids through the exchange and computes the same loss
    from them, and each lookup's gradient reaches the owners: without this
    share the owners would sum S copies of the one gradient."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _dropped_total(dropped, mesh: Mesh) -> torch.Tensor:
    return all_reduce(torch.as_tensor(dropped, dtype=torch.int32).reshape(1), mesh,
                      DATA_AXIS)[0]


def sharded_gather_a2a(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh,
                       capacity_factor: float | None = 2.0, dedup: bool = False,
                       return_stats: bool = False):
    """Row-sharded lookup through an all-to-all id exchange: each rank
    buckets its ids by owner shard at ``C = a2a_capacity(n, S, cf)`` slots
    a bucket, the owners gather their rows, and the vectors come back.
    ``dedup`` exchanges each rank's unique ids only.  With
    ``return_stats``: (out, dropped), the global count of ids that
    overflowed this call (an int32 scalar tensor, the same on every rank)."""
    ids = rows.reshape(-1).long()
    if dedup:
        ids, inverse = unique_with_counts_static(ids)
    cap = a2a_capacity(ids.shape[0], mesh.size(MODEL_AXIS), capacity_factor)
    (out,), dropped = _exchange(table, [ids], mesh, cap)
    out = _ReplicaShare.apply(out, mesh.size(MODEL_AXIS))
    if dedup:
        out = out.index_select(0, inverse)
    out = out.reshape(*rows.shape, table.shape[1])
    return (out, _dropped_total(dropped, mesh)) if return_stats else out


def sharded_gather_a2a_pipelined(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh,
                                 num_chunks: int = 2, capacity_factor: float | None = 2.0,
                                 dedup: bool = False, return_stats: bool = False):
    """``sharded_gather_a2a`` in ``num_chunks`` id chunks (padded with -1),
    each with the capacity of its own length, so the chunks move the
    single-shot engine's bytes in all; drops are counted per chunk.
    ``dedup`` dedups before chunking."""
    flat = rows.reshape(-1).long()
    if dedup:
        flat, inverse = unique_with_counts_static(flat)
    n = flat.shape[0]
    k = max(1, min(num_chunks, n))
    pad = pad_to_multiple(n, k) - n
    flat = torch.cat([flat, flat.new_full((pad,), -1)])
    chunks = list(flat.view(k, -1))
    cap = a2a_capacity(chunks[0].shape[0], mesh.size(MODEL_AXIS), capacity_factor)
    outs, dropped = _exchange(table, chunks, mesh, cap)
    out = _ReplicaShare.apply(torch.cat(outs)[:n], mesh.size(MODEL_AXIS))
    if dedup:
        out = out.index_select(0, inverse)
    out = out.reshape(*rows.shape, table.shape[1])
    return (out, _dropped_total(dropped, mesh)) if return_stats else out


def shard_table_cols(table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's column shard of a (V, D) table (D divisible by the
    model axis)."""
    n, s = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if table.shape[1] % n:
        raise ValueError(f"{table.shape[1]} columns do not split over a model axis of {n}")
    ds = table.shape[1] // n
    return table[:, s * ds:(s + 1) * ds]


def sharded_gather_cols(table: torch.Tensor, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Lookup in a column-sharded table: each rank gathers its D-slice of
    every row (no id exchange) and the slices are all-gathered along D."""
    emb = table.index_select(0, rows.reshape(-1).long())
    return AllGatherCols.apply(emb, mesh, MODEL_AXIS).reshape(*rows.shape, -1)


def unique_with_counts_static(ids: torch.Tensor):
    """Static-shape dedup: (uniq, inverse) with ``uniq`` as long as ``ids``,
    its first slots the sorted unique values and the rest -1 (padding to
    every engine), and ``uniq[inverse] == ids``; the JAX function's
    output, value for value."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    group = torch.cumsum(first.long(), 0) - 1
    uniq = torch.zeros_like(ids).scatter_(0, group, sorted_ids)
    n_uniq = group[-1] + 1 if n else 0
    uniq = torch.where(torch.arange(n, device=ids.device) < n_uniq, uniq, -1)
    inverse = torch.empty_like(ids)
    inverse[order] = group.to(ids.dtype)
    return uniq, inverse
