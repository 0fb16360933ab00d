"""Evaluation metrics: binned AUC, exact AUC, the ranked-candidate
HR/NDCG@K and retrieval recall@K, in numpy, and the binned AUC's
histograms on the device (``auc_histogram_torch``, ``AucAccumulator``).

The binned AUC is the JAX package's estimator: per-class histograms of
sigmoid-space scores over fixed bins, then the trapezoidal area over the
cumulative TPR/FPR (the estimator Keras' bucketed AUC uses).
"""
from __future__ import annotations

import numpy as np
import torch


def auc_histogram(scores, labels, num_bins: int = 2048, weights=None):
    """Bin scores in [0, 1] into per-class histograms (pos, neg), each
    (num_bins,).  Bins are computed in f32 as in the JAX package."""
    scores = np.clip(np.asarray(scores, np.float32), 0.0, 1.0)
    bins = np.minimum((scores * np.float32(num_bins)).astype(np.int32), num_bins - 1)
    labels = np.asarray(labels, np.float64)
    w = np.ones_like(labels) if weights is None else np.asarray(weights, np.float64)
    pos = np.bincount(bins, weights=labels * w, minlength=num_bins)
    neg = np.bincount(bins, weights=(1.0 - labels) * w, minlength=num_bins)
    return pos, neg


def auc_histogram_torch(scores: torch.Tensor, labels: torch.Tensor, num_bins: int = 2048,
                        weights: torch.Tensor | None = None):
    """``auc_histogram`` on the scores' device: bins in f32 as
    ``(clip(s, 0, 1) · num_bins)`` cast to int32, capped at num_bins - 1;
    returns the f32 (pos, neg) histograms, each row weighted by
    ``weights`` (its validity)."""
    s = scores.float().clamp(0.0, 1.0)
    bins = torch.clamp_max((s * num_bins).to(torch.int32), num_bins - 1).long()
    y = labels.float()
    w = torch.ones_like(y) if weights is None else weights.float()
    pos = torch.zeros(num_bins, dtype=torch.float32, device=s.device).index_add_(0, bins, y * w)
    neg = torch.zeros(num_bins, dtype=torch.float32, device=s.device).index_add_(
        0, bins, (1.0 - y) * w)
    return pos, neg


class AucAccumulator:
    """Streaming binned AUC: two f32 histograms on ``device`` that each
    batch's scores in [0, 1] add to; nothing per example reaches the host."""

    def __init__(self, num_bins: int = 2048, device=None):
        self.num_bins = num_bins
        self.pos = torch.zeros(num_bins, dtype=torch.float32, device=device)
        self.neg = torch.zeros(num_bins, dtype=torch.float32, device=device)

    def update(self, scores: torch.Tensor, labels: torch.Tensor, weights=None) -> None:
        p, n = auc_histogram_torch(scores, labels, self.num_bins, weights)
        self.pos += p
        self.neg += n

    def result(self) -> float:
        return auc_from_histogram(self.pos.cpu().double().numpy(),
                                  self.neg.cpu().double().numpy())


def auc_from_histogram(pos, neg) -> float:
    """Trapezoidal AUC from per-class score histograms; 0.5 when one class
    is absent, matching :func:`auc_exact`."""
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    if tp[-1] == 0.0 or fp[-1] == 0.0:
        return 0.5
    tpr = np.concatenate([[0.0], tp / tp[-1]])
    fpr = np.concatenate([[0.0], fp / fp[-1]])
    return float(np.sum((fpr[1:] - fpr[:-1]) * 0.5 * (tpr[1:] + tpr[:-1])))


def auc(scores, labels, num_bins: int = 8192) -> float:
    """One-shot binned AUC on host arrays."""
    return auc_from_histogram(*auc_histogram(scores, labels, num_bins))


def auc_exact(scores, labels) -> float:
    """Exact Mann-Whitney AUC with average ranks for ties."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def hit_rate_ndcg_at_k(pos_scores, neg_scores, k: int) -> tuple[float, float]:
    """Rank each example's positive among its negatives: pos (B,), neg
    (B, N) -> (HR@k, NDCG@k), computed in f32 as the JAX package does.  The
    0-based rank counts the negatives scored strictly above the positive."""
    pos = np.asarray(pos_scores, np.float32)
    rank = (np.asarray(neg_scores, np.float32) > pos[:, None]).sum(-1)
    hit = (rank < k).astype(np.float32)
    ndcg = hit * (np.float32(1.0) / np.log2(rank.astype(np.float32) + np.float32(2.0)))
    return float(hit.mean()), float(ndcg.mean())


def recall_at_k(retrieved_ids, true_ids) -> float:
    """Share of examples whose true item is among their retrieved ids:
    retrieved (B, K), true (B,)."""
    hits = (np.asarray(retrieved_ids) == np.asarray(true_ids)[:, None]).any(axis=1)
    return float(hits.mean())
