"""Embedding gather and pooled lookup, plain PyTorch (the port's copy of
``recsys_tpu/kernels/embedding.py``'s logical-table ops), and the plain
version of the pooled-gather kernel.

* ``gather(table, rows)`` -- (V, D) table, integer ``rows`` of any shape ->
  ``rows.shape + (D,)``.
* ``pool(emb, mask, mode)`` -- (B, L, D) -> (B, D) over the unmasked
  positions: ``sum``, ``mean`` or ``sqrtn`` (the count clamped to 1).
* ``segment_sum_gather(table, rows, mask, mode)`` -- ``pool(gather(...))``.
* ``pooled_gather(table, rows, mask)`` -- the masked SUM in f32, what
  ``csrc/pooled_gather.cu`` computes (the mean and sqrtn scalings are
  applied outside it, as around the TPU kernel).
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean", "sqrtn")


def gather(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Embed ``rows`` (any shape) from ``table`` (V, D)."""
    return table.index_select(0, rows.reshape(-1).long()).reshape(*rows.shape, -1)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown pooling mode {mode!r}")


def pool_scale(summed: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """Apply ``mode``'s scaling to a masked sum (B, D)."""
    check_mode(mode)
    if mode == "sum":
        return summed
    count = mask.to(summed.dtype).sum(1).clamp_min(1.0)[:, None]
    return summed / count if mode == "mean" else summed / count.sqrt()


def pool(emb: torch.Tensor, mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """Pool (B, L, D) embeddings over the unmasked positions -> (B, D)."""
    check_mode(mode)
    return pool_scale((emb * mask.to(emb.dtype)[..., None]).sum(1), mask, mode)


def segment_sum_gather(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean") -> torch.Tensor:
    """Pooled embedding of padded sequences: rows (B, L), mask (B, L)
    (nonzero = a real position) -> (B, D)."""
    return pool(gather(table, rows), mask, mode)


def pooled_gather(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The pooled-gather kernel's function: (V, D) f32 or bf16 table, (B, L)
    rows, (B, L) mask -> the (B, D) f32 sum of the rows at nonzero mask
    positions; a row with none is 0."""
    emb = gather(table, rows).float()
    return (emb * (mask != 0).to(torch.float32)[..., None]).sum(1)
