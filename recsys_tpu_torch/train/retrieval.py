"""Brute-force top-k retrieval (the port's copy of
``recsys_tpu/train/retrieval.py``): score every catalog item against every
query on the device and keep the k best.

Routing follows the JAX package's, by k, and the kernel's registers, by
D: where the fused kernel applies (k <= 16, more than k items and D <=
128, ``kernels/topk.py::in_domain``) both functions call
``dispatch.topk_scores_fused``, which launches the top-k kernel on a CUDA
tensor (its plain version on a CPU tensor) and never materialises the
(Q, N) scores.  Outside that domain they compute what the JAX package's
XLA route computes, on any device: ``topk_scores`` the full score matrix
and its k best, ``topk_scores_streaming`` a scan over catalog tiles
merging a running (Q, k) set.  Those select with a stable descending sort,
not ``torch.topk``, whose order among equal scores is unspecified: equal
scores rank the lower item id first, as ``lax.top_k`` and the kernel rank
them.  ``topk_scores_sharded`` splits the catalog over the model axis of a
mesh: each rank takes the top k of its shard through ``topk_scores``
(the kernel, in its domain) and the candidates merge after an all-gather.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.kernels import topk as topk_ref
from recsys_tpu_torch.parallel import mesh as mesh_lib


def _as_tensor(x, device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def _l2(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def topk_scores(query_embs: torch.Tensor, item_embs: torch.Tensor, k: int = 10,
                normalize: bool = False):
    """(Q, D) x (N, D) -> (values (Q, k) f32, indices (Q, k) int32), best
    first."""
    if normalize:
        query_embs, item_embs = _l2(query_embs), _l2(item_embs)
    if topk_ref.in_domain(k, *item_embs.shape):
        return dispatch.topk_scores_fused(query_embs, item_embs, k)
    return score_matrix_topk(query_embs, item_embs, k)


def score_matrix_topk(query_embs: torch.Tensor, item_embs: torch.Tensor, k: int = 10):
    """``topk_scores``'s route outside the kernel's domain: the whole (Q, N)
    f32 score matrix and a stable sort of each row."""
    return _best(query_embs.float() @ item_embs.float().T, k)


def _best(scores: torch.Tensor, k: int):
    """The k best columns of each row, best first, ties to the lower column."""
    values, cols = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], cols[:, :k].to(torch.int32)


def topk_scores_sharded(mesh, query_embs: torch.Tensor, item_embs: torch.Tensor,
                        k: int = 10, normalize: bool = False):
    """Catalog-sharded top-k over the model axis of ``mesh``: every rank
    passes the same queries and the whole catalog, takes the top k of its
    rows ``[s·ceil(N/S), (s+1)·ceil(N/S))`` (ids made global; a shard of
    fewer than k rows fills with -inf scores past the catalog), and the
    S·k candidates of each query merge after one all-gather, ties to the
    lower id.  Returns what ``topk_scores`` returns, on every rank."""
    n_model, s = mesh.size(mesh_lib.MODEL_AXIS), mesh.index(mesh_lib.MODEL_AXIS)
    n = item_embs.shape[0]
    ns = -(-n // n_model)
    lo, hi = min(s * ns, n), min((s + 1) * ns, n)
    q = query_embs
    values = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    ids = torch.full((q.shape[0], k), n, dtype=torch.int32, device=q.device)
    kk = min(k, hi - lo)
    if kk:
        v, i = topk_scores(q, item_embs[lo:hi], kk, normalize)
        values[:, :kk], ids[:, :kk] = v, i + lo
    # (S·Q, k) in shard order: a stable sort keeps the lower id first on ties
    av = mesh_lib.all_gather(values, mesh, mesh_lib.MODEL_AXIS)
    ai = mesh_lib.all_gather(ids, mesh, mesh_lib.MODEL_AXIS)
    av = av.view(n_model, q.shape[0], k).transpose(0, 1).reshape(q.shape[0], -1)
    ai = ai.view(n_model, q.shape[0], k).transpose(0, 1).reshape(q.shape[0], -1)
    best_v, sel = _best(av, k)
    return best_v, ai.gather(1, sel.long())


def topk_scores_streaming(query_embs: torch.Tensor, item_embs: torch.Tensor, k: int = 10,
                          tile: int = 8192, normalize: bool = False):
    """Memory-bounded top-k: at most O(Q·(tile + k)) scores at a time."""
    if normalize:
        query_embs, item_embs = _l2(query_embs), _l2(item_embs)
    if topk_ref.in_domain(k, *item_embs.shape):
        return dispatch.topk_scores_fused(query_embs, item_embs, k)
    return tile_scan_topk(query_embs, item_embs, k, tile)


def tile_scan_topk(query_embs: torch.Tensor, item_embs: torch.Tensor, k: int = 10,
                   tile: int = 8192):
    """``topk_scores_streaming``'s route outside the kernel's domain: the
    catalog in tiles of ``tile`` items, each tile's scores merged into the
    running best k by a stable sort."""
    q = query_embs.float()
    best_v = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int32, device=q.device)
    for lo in range(0, item_embs.shape[0], tile):
        scores = q @ item_embs[lo:lo + tile].float().T
        ids = torch.arange(lo, lo + scores.shape[1], dtype=torch.int32, device=q.device)
        best_v, sel = _best(torch.cat([best_v, scores], 1), k)
        best_i = torch.cat([best_i, ids.expand(q.shape[0], -1)], 1).gather(1, sel.long())
    return best_v, best_i


class BruteForceIndex:
    """A faiss-like index (``IndexFlatIP``): ``index = BruteForceIndex(dim);
    index.add(items); values, ids = index.search(queries, k)``, scoring on
    ``device`` (``cuda`` unless the caller names another) and returning
    numpy arrays."""

    def __init__(self, dim: int, normalize: bool = False, device=None):
        self.dim = dim
        self.normalize = normalize
        self.device = default_device(device)
        self._items = None

    def add(self, item_embs) -> None:
        items = _as_tensor(item_embs, self.device)
        self._items = items if self._items is None else torch.cat([self._items, items])

    @property
    def ntotal(self) -> int:
        return 0 if self._items is None else int(self._items.shape[0])

    def search(self, query_embs, k: int):
        if self._items is None:
            raise ValueError("index is empty; call add() first")
        q = _as_tensor(query_embs, self.device)
        with torch.inference_mode():
            values, indices = topk_scores(q, self._items, k, self.normalize)
        return values.cpu().numpy(), indices.cpu().numpy()
