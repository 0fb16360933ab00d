"""Synthetic fixtures (the port's copy of recsys_tpu.data.synthetic's
``synthetic_ctr``, ``synthetic_multitask`` and ``synthetic_sequence``: the
same numpy draws from the same seed, so both packages see identical
arrays).

Labels are Bernoulli draws from a hidden random linear model over the
features, so a trained model has signal to find.
"""
from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.features import (
    DenseFeature,
    FeatureSchema,
    SparseFeature,
    VarLenSparseFeature,
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


def synthetic_sequence(num_examples: int = 4096, num_items: int = 200, max_len: int = 20,
                       embed_dim: int = 8, seed: int = 0):
    """DIN-style behaviour sequences: a target item and a front-filled
    history of 1..``max_len`` items (0 pads the rest); the label is 1 when
    the target's hidden cluster (one of 8) is the history's most common,
    flipped with probability 0.1.  Returns (schema, {'sparse': (N, 1)
    target, 'hist': (N, max_len), 'label': (N,)})."""
    rng = np.random.default_rng(seed)
    clusters = rng.integers(0, 8, num_items + 1)  # item -> hidden cluster
    hist = rng.integers(1, num_items + 1, (num_examples, max_len))
    lengths = rng.integers(1, max_len + 1, num_examples)
    mask = np.arange(max_len)[None, :] < lengths[:, None]
    hist = np.where(mask, hist, 0).astype(np.int32)
    target = rng.integers(1, num_items + 1, num_examples).astype(np.int32)
    hist_cl = clusters[hist]
    maj = np.asarray([np.bincount(hist_cl[i][mask[i]], minlength=8).argmax()
                      for i in range(num_examples)])
    noise = rng.random(num_examples) < 0.1
    label = ((clusters[target] == maj) ^ noise).astype(np.float32)
    schema = FeatureSchema(
        sparse=[SparseFeature("item", num_items + 1, embed_dim)],
        varlen=[VarLenSparseFeature("hist_item", num_items + 1, embed_dim, max_len=max_len,
                                    shared_with="item")])
    return schema, {"sparse": target[:, None], "hist": hist, "label": label}
