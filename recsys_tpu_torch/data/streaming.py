"""Out-of-core training data (the port of ``recsys_tpu/data/streaming.py``):
Criteo files streamed chunk by chunk through the C++ parser
(``data/native.py``), so host memory holds one chunk however large the
files are.

Categoricals are hashed (FNV-1a 64) into ``cat_buckets`` a field.  Dense
columns are min-max scaled with per-column bounds from one pass over the
files before training.
"""
from __future__ import annotations

import glob as globlib
import os

import numpy as np

from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
from recsys_tpu_torch.data import native
from recsys_tpu_torch.data.criteo import DENSE_COLS, SPARSE_COLS


class CriteoStream:
    """Re-iterable batches ``{'label', 'dense', 'sparse'}`` of exactly
    ``batch_size`` rows over a Criteo file glob (or a list of paths).

    Each ``iter()`` is one pass over the files in sorted order: a short
    chunk's rows are carried across chunk and file boundaries and the last
    partial batch is dropped, as ``fit`` drops its remainder.  ``shuffle``
    permutes the rows within each chunk (a window shuffle) with
    ``default_rng(seed + pass)``, the pass counted from 0 on this object.
    Hand the object to ``Trainer.fit``, ``evaluate_loss`` or
    ``evaluate_auc``."""

    def __init__(self, paths, batch_size: int = 512, *, chunk_rows: int = 65536,
                 cat_buckets: int = native.DEFAULT_BUCKETS, embed_dim: int = 16,
                 shuffle: bool = True, seed: int = 0):
        self.files = sorted(globlib.glob(paths)) if isinstance(paths, str) else list(paths)
        if not self.files:
            raise ValueError(f"no files match {paths!r}")
        for p in self.files:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.batch_size = batch_size
        self.chunk_rows = max(batch_size, chunk_rows)
        self.cat_buckets = cat_buckets
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._fmt = {p: native.detect_format(p) for p in self.files}
        self.schema = FeatureSchema(dense=[DenseFeature(c) for c in DENSE_COLS],
                                    sparse=[SparseFeature(c, cat_buckets, embed_dim)
                                            for c in SPARSE_COLS])
        self._compute_stats()

    def _chunks(self):
        """(labels, dense, sparse) views of two reused chunk buffers."""
        out = native.new_buffers(self.chunk_rows)
        for path in self.files:
            sep, skip = self._fmt[path]
            off = 0
            while True:
                (lab, den, spa), off = native.parse_criteo_chunk(
                    path, off, self.chunk_rows, sep=sep, cat_buckets=self.cat_buckets,
                    skip_header=skip, out=out)
                if lab.shape[0] == 0:
                    break
                yield lab, den, spa

    def _compute_stats(self) -> None:
        """One pass for the rows and each dense column's bounds."""
        mn = np.full(13, np.inf, np.float32)
        mx = np.full(13, -np.inf, np.float32)
        n = 0
        for lab, den, _ in self._chunks():
            mn = np.minimum(mn, den.min(axis=0))
            mx = np.maximum(mx, den.max(axis=0))
            n += lab.shape[0]
        if n == 0:
            raise ValueError(f"no valid rows in {self.files}")
        self.num_rows = n
        self._mn = mn
        self._scale = 1.0 / np.where(mx > mn, mx - mn, 1.0)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        bs = self.batch_size
        carry = None
        for lab, den, spa in self._chunks():
            den = (den - self._mn) * self._scale
            if self.shuffle:
                perm = rng.permutation(lab.shape[0])
                lab, den, spa = lab[perm], den[perm], spa[perm]
            if carry is not None:
                lab, den, spa = (np.concatenate([c, x]) for c, x in zip(carry, (lab, den, spa)))
                carry = None
            n_full = (lab.shape[0] // bs) * bs
            for s in range(0, n_full, bs):
                yield {"label": lab[s:s + bs].copy(), "dense": den[s:s + bs].copy(),
                       "sparse": spa[s:s + bs].copy()}
            if n_full < lab.shape[0]:
                carry = [lab[n_full:].copy(), den[n_full:].copy(), spa[n_full:].copy()]
