"""Fused retrieval scoring + top-k, plain PyTorch: the function of
``csrc/topk_scores.cu`` (the JAX package's ``topk_scores_pallas``).

(Q, D) queries and (N, D) items -> the k best items of every query, values
(Q, k) f32 and indices (Q, k) int32, best first; equal scores rank the
lower item id first.  The catalog streams in tiles, as
``recsys_tpu/train/retrieval.py::topk_scores_streaming`` streams it, and a
running (Q, k) set is merged with each tile's scores.  The merge selects on
one int64 key per candidate, the score's order-preserving bits above the
complement of its id, so the order (score desc, id asc) is exact whatever
``torch.topk`` does with ties.  No (Q, N) matrix is kept beyond one tile.
"""
from __future__ import annotations

import torch

MAX_K = 16  # the kernel's domain: 1 <= k <= 16, N > k and D <= MAX_D
MAX_D = 128  # csrc/topk_scores.cu's kMaxD: a warp's query rows stay in registers
_ID_MAX = 2**31 - 1  # the id of an empty slot, after every real item


def takes_k(k: int, n: int) -> bool:
    """Whether the kernel takes the k best of n items: 1 <= k <= 16, N > k."""
    return 1 <= k <= MAX_K and n > k


def fits_d(k: int, d: int) -> bool:
    """Whether ``topk_scores_plan`` (``csrc/topk_scores.cu``) takes head
    width ``d``: d padded to a multiple of 4 lies in [4, 128], so that a
    warp's 16 query rows, split into big and small TF32 parts, fit its
    registers (k in [1, 16] as well)."""
    return 1 <= k <= MAX_K and 4 <= 4 * -(-d // 4) <= MAX_D


def in_domain(k: int, n: int, d: int) -> bool:
    """Whether the kernel takes the k best of n items of width d; the
    mirror of ``topk_scores_plan``'s refusals."""
    return takes_k(k, n) and fits_d(k, d)


def _keys(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score desc, id asc) under plain comparison."""
    bits = (scores + 0.0).view(torch.int32)  # -0.0 -> +0.0, as the comparison sees them
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # monotone in the score
    return (bits.long() << 32) | (_ID_MAX - ids.long())


def topk_scores(q: torch.Tensor, items: torch.Tensor, k: int = 10,
                tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function (at any 1 <= k <= N); the exact f32 dot
    products are ``q @ tileᵀ``."""
    if not 1 <= k <= items.shape[0]:
        raise ValueError(f"topk_scores: k={k} outside [1, N={items.shape[0]}]")
    q, items = q.float(), items.float()
    nq, n = q.shape[0], items.shape[0]
    best_v = torch.full((nq, k), float("-inf"), device=q.device)
    best_i = torch.full((nq, k), _ID_MAX, dtype=torch.int32, device=q.device)
    best_key = _keys(best_v, best_i)
    for lo in range(0, n, tile):
        scores = q @ items[lo:lo + tile].T
        ids = torch.arange(lo, lo + scores.shape[1], dtype=torch.int32,
                           device=q.device).expand(nq, -1)
        cat_v = torch.cat([best_v, scores], 1)
        cat_i = torch.cat([best_i, ids], 1)
        best_key, sel = torch.topk(torch.cat([best_key, _keys(scores, ids)], 1), k)
        best_v, best_i = cat_v.gather(1, sel), cat_i.gather(1, sel)
    return best_v, best_i
