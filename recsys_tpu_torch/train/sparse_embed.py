"""Where the embedding tables live and which batch columns feed each one,
the embedding optimizers' state, and the touched-rows ("sparse") updates
``lazy_adam`` and ``rowwise_adagrad`` (the port of
recsys_tpu.train.sparse_embed).

The port's tables are logical ``(V_g, D)`` with one vocab row per table
row, so the plan carries no row-packing factor, and a touched row is a
vocab row.

A row is touched when its id occurs in the batch, even where its summed
gradient is exactly 0: its moments decay and weight decay applies to it.
Rows the batch does not hold, with their state, are left as they are, bit
for bit.  Duplicate ids sum their gradients before the update.  The
updates are torch ops: ``unique`` for the touched rows, ``index_add_`` for
the sums (whose order over duplicates is not fixed on a CUDA device).
"""
from __future__ import annotations

import dataclasses

import torch

from recsys_tpu_torch.ops.embedding import StackedEmbedding

KINDS = ("lazy_adam", "rowwise_adagrad")


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    """Per group table: its name, the schema.sparse columns it serves and
    each column's offset in it, and its stacked vocabulary."""

    table_names: tuple[str, ...]
    group_cols: tuple[tuple[int, ...], ...]
    group_offsets: tuple[tuple[int, ...], ...]
    group_vocab: tuple[int, ...]
    embed_dim: int


def build_plan(embedding: StackedEmbedding) -> EmbedPlan:
    """The plan of ``embedding``'s group tables that serve a sparse column."""
    if embedding.schema.varlen:
        raise ValueError(
            "fused embedding updates cover StackedEmbedding.forward only; "
            "the schema has varlen fields whose gradients would be lost"
        )
    groups = embedding.groups()
    return EmbedPlan(
        table_names=tuple(f"table_{g}" for g in groups),
        group_cols=tuple(tuple(getattr(embedding, f"cols_{g}").tolist()) for g in groups),
        group_offsets=tuple(tuple(getattr(embedding, f"offs_{g}").tolist()) for g in groups),
        group_vocab=tuple(embedding.group_vocab[g] for g in groups),
        embed_dim=embedding.schema.embed_dim,
    )


def init_state(tables: dict, kind: str) -> dict:
    """Zero optimizer state per table, always f32 whatever the table dtype
    (bf16's 8-bit mantissa would destroy Adam's second moment):
    ``lazy_adam`` gives Adam's ``m`` and ``v`` shaped like the table (the
    fused Adam update uses them as dense Adam's moments),
    ``rowwise_adagrad`` one accumulator per row, ``acc`` (V,)."""
    if kind == "lazy_adam":
        return {name: {"m": torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                       "v": torch.zeros(t.shape, dtype=torch.float32, device=t.device)}
                for name, t in tables.items()}
    if kind == "rowwise_adagrad":
        return {name: {"acc": torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)}
                for name, t in tables.items()}
    raise ValueError(f"unknown embedding optimizer state {kind!r}: {KINDS}")


def group_rows_and_cots(plan: EmbedPlan, sparse_ids: torch.Tensor, pert_grad: torch.Tensor):
    """Per group: (rows (B·F_g,), cot (B·F_g, D)), the table rows of the
    batch's ids column by column and the (B, F, D) tap cotangent beside
    them."""
    out = []
    for cols, offsets in zip(plan.group_cols, plan.group_offsets):
        rows = torch.cat([sparse_ids[:, j].long() + off for j, off in zip(cols, offsets)])
        cot = torch.cat([pert_grad[:, j, :] for j in cols])
        out.append((rows, cot))
    return out


def _dedup(rows: torch.Tensor, cot: torch.Tensor):
    """(touched rows (U,) in ascending order, their summed cotangent (U, D))."""
    uids, inv = torch.unique(rows, return_inverse=True)
    g = torch.zeros((uids.shape[0], cot.shape[1]), dtype=cot.dtype, device=cot.device)
    return uids, g.index_add_(0, inv, cot)


def lazy_adam_update(table, m, v, rows, cot, *, lr, step, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0) -> None:
    """Adam at the touched rows only, in place; the bias correction uses the
    global ``step`` (1-based), cast to the table's dtype as the JAX package
    casts it, so an f32 table computes ``b1**t`` in f32."""
    uids, g = _dedup(rows, cot)
    mu = m[uids].mul_(b1).add_((1.0 - b1) * g)
    vu = v[uids].mul_(b2).add_((1.0 - b2) * (g * g))
    m[uids], v[uids] = mu, vu
    t = torch.tensor(step, dtype=table.dtype, device=table.device)
    m_hat = mu / (1.0 - torch.tensor(b1, dtype=table.dtype, device=table.device) ** t)
    v_hat = vu / (1.0 - torch.tensor(b2, dtype=table.dtype, device=table.device) ** t)
    upd = -lr * m_hat / (torch.sqrt(v_hat) + eps)
    old = table[uids]
    if weight_decay:
        upd = upd - lr * weight_decay * old
    table[uids] = old + upd.to(table.dtype)


def rowwise_adagrad_update(table, acc, rows, cot, *, lr, eps=1e-8, weight_decay=0.0) -> None:
    """Rowwise AdaGrad at the touched rows, in place: each row's
    accumulator (``acc`` (V,)) adds the mean of its g² over D, and each
    value moves by ``-lr · g / (sqrt(acc) + eps)``, a division a value."""
    uids, g = _dedup(rows, cot)
    au = acc[uids] + torch.mean(g * g, dim=-1)
    acc[uids] = au
    upd = -lr * g / (torch.sqrt(au)[:, None] + eps)
    old = table[uids]
    if weight_decay:
        upd = upd - lr * weight_decay * old
    table[uids] = old + upd.to(table.dtype)


def apply_updates(tables: dict, state: dict, plan: EmbedPlan, sparse_ids: torch.Tensor,
                  pert_grad: torch.Tensor, *, kind: str, lr: float, step: int,
                  weight_decay: float = 0.0, row_offsets: dict | None = None) -> None:
    """One touched-rows step of ``kind`` over every group table, in place:
    ``state[name]`` is ``{'m', 'v'}`` for ``lazy_adam``, ``{'acc'}`` for
    ``rowwise_adagrad`` (``init_state``'s).  A table named in
    ``row_offsets`` is a model shard, the rows ``[offset, offset + len)``
    of the global table, whose state follows its rows: it takes the
    batch's occurrences in its rows only."""
    if kind not in KINDS:
        raise ValueError(f"unknown sparse embedding optimizer {kind!r}: {KINDS}")
    with torch.no_grad():
        for name, (rows, cot) in zip(plan.table_names,
                                     group_rows_and_cots(plan, sparse_ids, pert_grad)):
            if row_offsets and name in row_offsets:
                off = row_offsets[name]
                mine = (rows >= off) & (rows < off + tables[name].shape[0])
                rows, cot = rows[mine] - off, cot[mine]
            st = state[name]
            if kind == "lazy_adam":
                lazy_adam_update(tables[name], st["m"], st["v"], rows, cot, lr=lr, step=step,
                                 weight_decay=weight_decay)
            else:
                rowwise_adagrad_update(tables[name], st["acc"], rows, cot, lr=lr,
                                       weight_decay=weight_decay)
