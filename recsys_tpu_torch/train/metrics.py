"""Evaluation metrics: binned AUC and exact AUC, in numpy.

The binned AUC is the JAX package's estimator: per-class histograms of
sigmoid-space scores over fixed bins, then the trapezoidal area over the
cumulative TPR/FPR (the estimator Keras' bucketed AUC uses).
"""
from __future__ import annotations

import numpy as np


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
