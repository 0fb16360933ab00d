"""The Criteo CTR dataset of the port (the counterpart of
``recsys_tpu/data/criteo.py``), without pandas: the label-encode protocol
on a CSV file with a header (label, I1..I13, C1..C26).  Files too large
for it stream through the C++ parser instead (``data/streaming.py``).

Splits are dicts ``{'dense': (N, 13) f32, 'sparse': (N, 26) int32,
'label': (N,) f32}``; each dense column is min-max scaled by its own
minimum and maximum.

The label-encode path types each column as ``pandas.read_csv`` does
(``table.read_table``), fills a missing categorical with ``"-1"`` and a
missing dense value with 0, then codes each categorical column as
``pandas.factorize(sort=True)`` does.  A categorical column whose every
present value is a number reads as numbers; with a gap, its filled values
are numbers and the text ``"-1"``, which pandas sorts numbers first and
text last: ``[9.0, 45.0, 123.0, '-1']``.
"""
from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
from recsys_tpu_torch.data.table import read_table

DENSE_COLS = [f"I{i}" for i in range(1, 14)]
SPARSE_COLS = [f"C{i}" for i in range(1, 27)]


def create_criteo_dataset(path: str, embed_dim: int = 8, test_size: float = 0.2,
                          read_part: bool = False, sample_num: int = 100_000, seed: int = 2020):
    """A Criteo CSV file -> (schema, train, test); ``read_part`` reads only
    the first ``sample_num`` rows."""
    return build_criteo_arrays(read_table(path, nrows=sample_num if read_part else None),
                               embed_dim, test_size, seed)


def factorize_sorted(col: np.ndarray, fill: str = "-1") -> tuple[np.ndarray, int]:
    """(codes int32, vocabulary size) of ``col`` with its gaps filled by
    ``fill``, coded as ``pandas.factorize(sort=True)`` codes it: numbers in
    numeric order and, in a numeric column with gaps, ``fill`` after them;
    text in code-point order with ``fill`` among it."""
    if col.dtype.kind in "iu":
        uniq, codes = np.unique(col, return_inverse=True)
        return codes.reshape(-1).astype(np.int32), len(uniq)
    if col.dtype.kind == "f":
        gap = np.isnan(col)
        uniq, codes = np.unique(col[~gap], return_inverse=True)
        out = np.full(len(col), len(uniq), np.int32)
        out[~gap] = codes.reshape(-1)
        return out, len(uniq) + int(gap.any())
    text = np.asarray([fill if v is None else v for v in col], dtype=str)
    uniq, codes = np.unique(text, return_inverse=True)
    return codes.reshape(-1).astype(np.int32), len(uniq)


def _dense_column(col: np.ndarray, name: str) -> np.ndarray:
    """A dense column with its gaps filled by 0, as f32."""
    if col.dtype.kind not in "iuf":
        raise ValueError(f"dense column {name!r} holds text")
    return np.where(np.isnan(col), 0.0, col) if col.dtype.kind == "f" else col


def build_criteo_arrays(cols: dict, embed_dim: int = 8, test_size: float = 0.2,
                        seed: int = 2020):
    """The label-encode protocol on typed columns (``table.read_table``'s) ->
    (schema, train, test)."""
    need = ["label", *DENSE_COLS, *SPARSE_COLS]
    absent = [c for c in need if c not in cols]
    if absent:
        raise ValueError(f"columns {absent} missing")
    n = len(cols["label"])
    sparse = np.empty((n, len(SPARSE_COLS)), np.int32)
    vocab_sizes = []
    for j, c in enumerate(SPARSE_COLS):
        sparse[:, j], v = factorize_sorted(cols[c])
        vocab_sizes.append(v)
    dense = np.empty((n, len(DENSE_COLS)), np.float32)
    for j, c in enumerate(DENSE_COLS):
        dense[:, j] = _dense_column(cols[c], c)
    label = cols["label"]
    if label.dtype.kind not in "iuf":
        raise ValueError("column 'label' holds text")
    schema = FeatureSchema(dense=[DenseFeature(c) for c in DENSE_COLS],
                           sparse=[SparseFeature(c, int(v), embed_dim)
                                   for c, v in zip(SPARSE_COLS, vocab_sizes)])
    return (schema,) + _split(_minmax(dense), sparse, label.astype(np.float32), test_size, seed)


def _minmax(dense: np.ndarray) -> np.ndarray:
    """Per-column min-max scaling."""
    mn, mx = dense.min(axis=0), dense.max(axis=0)
    return (dense - mn) / np.where(mx > mn, mx - mn, 1.0)


def _split(dense, sparse, label, test_size: float, seed: int):
    """A shuffled train/test split from one permutation of ``seed``."""
    idx = np.random.default_rng(seed).permutation(len(label))
    cut = int(len(label) * (1.0 - test_size))

    def take(sel):
        return {"dense": dense[sel], "sparse": sparse[sel], "label": label[sel]}

    return take(idx[:cut]), take(idx[cut:])
