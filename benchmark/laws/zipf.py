"""Ids by the Zipf law: rank k of a ``rows``-row table with probability
proportional to k^-a, for k = 1..rows, mapped to rows through a random
permutation fixed per field, so the hot rows lie anywhere in the table
(``bench.py``'s ``_zipf_col`` draws the same law by rejection).

Parameters: ``{"law": "zipf", "a": a}``."""
import torch


def ids(gen: torch.Generator, n: int, rows: int, params: dict, device) -> torch.Tensor:
    """(n,) int64 rows of a ``rows``-row table."""
    ranks = torch.arange(1, rows + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow_(-float(params["a"])), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    idx = torch.searchsorted(cdf, u).clamp_(max=rows - 1)
    return torch.randperm(rows, generator=gen, device=device)[idx]
