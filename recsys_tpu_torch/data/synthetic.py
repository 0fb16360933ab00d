"""Synthetic fixtures (the port's copy of recsys_tpu.data.synthetic's
``synthetic_ctr`` and ``synthetic_multitask``: the same numpy draws from
the same seed, so both packages see identical arrays).

Labels are Bernoulli draws from a hidden random linear model over the
features, so a trained model has signal to find.
"""
from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.features import (
    DenseFeature,
    FeatureSchema,
    SparseFeature,
)


def synthetic_ctr(
    num_examples: int = 8192,
    num_dense: int = 13,
    num_sparse: int = 26,
    vocab_size: int = 100,
    embed_dim: int = 8,
    seed: int = 0,
    signal: float = 1.0,
):
    """Criteo-shaped synthetic CTR data with a planted logistic model."""
    rng = np.random.default_rng(seed)
    dense = rng.random((num_examples, num_dense)).astype(np.float32)
    sparse = rng.integers(
        0, vocab_size, (num_examples, num_sparse), dtype=np.int32
    )

    w_dense = rng.normal(0, 1, num_dense)
    w_sparse = rng.normal(0, 1, (num_sparse, vocab_size))
    logits = dense @ w_dense + w_sparse[np.arange(num_sparse), sparse].sum(-1)
    logits = signal * (logits - logits.mean()) / (logits.std() + 1e-9)
    label = (rng.random(num_examples) < _sigmoid(logits)).astype(np.float32)

    schema = FeatureSchema(
        dense=[DenseFeature(f"I{i}") for i in range(num_dense)],
        sparse=[
            SparseFeature(f"C{i}", vocab_size, embed_dim)
            for i in range(num_sparse)
        ],
    )
    return schema, {"dense": dense, "sparse": sparse, "label": label}


def synthetic_multitask(num_examples: int = 8192, num_sparse: int = 8, vocab_size: int = 50,
                        embed_dim: int = 8, tasks: tuple = ("ctr", "cvr"), seed: int = 0):
    """Multi-task fixture (ESMM, MMoE, PLE): sparse ids and one label a
    task, each task's logit a shared random linear term plus its own.
    Returns (schema, {'sparse': (N, F) int32, 'labels': {task: (N,)}})."""
    rng = np.random.default_rng(seed)
    sparse = rng.integers(0, vocab_size, (num_examples, num_sparse), dtype=np.int32)

    def term():
        z = rng.normal(0, 1, (num_sparse, vocab_size))[np.arange(num_sparse), sparse].sum(-1)
        return (z - z.mean()) / (z.std() + 1e-9)

    base = term()
    labels = {}
    for name in tasks:
        logits = 0.7 * base + 0.7 * term()
        labels[name] = (rng.random(num_examples) < _sigmoid(logits)).astype(np.float32)
    schema = FeatureSchema(sparse=[SparseFeature(f"C{i}", vocab_size, embed_dim)
                                   for i in range(num_sparse)])
    return schema, {"sparse": sparse, "labels": labels}


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))
