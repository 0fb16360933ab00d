"""Where the embedding tables live and which batch columns feed each one,
and the optimizer state of the fused embedding updates (the part of
recsys_tpu.train.sparse_embed that the fused path needs).

The port's tables are logical ``(V_g, D)`` with one vocab row per table
row, so the plan carries no row-packing factor.
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
