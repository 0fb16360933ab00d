"""Ids drawn alike over every row of the table.

Parameters: ``{"law": "uniform"}``."""
import torch


def ids(gen: torch.Generator, n: int, rows: int, params: dict, device) -> torch.Tensor:
    """(n,) int64 rows of a ``rows``-row table."""
    return torch.randint(0, rows, (n,), generator=gen, device=device)
