"""The census-income two-task pipeline of MMoE and PLE (the port's copy of
``recsys_tpu/data/census.py``), without pandas: task 1 is income over 50k,
task 2 never married; the categorical columns are coded in sorted order
and embedded, the dense ones min-max scaled, and the test file split 1:1
into val and test.

``read_columns`` reads a headerless CSV file into columns typed as
``pandas.read_csv`` types them (``table.typed_column``): int64 where every
field is an integer, float64 where every field is a number, else the
fields' text as they stand; a census column has no missing field.  A column's codes come from each value turned back into text and
stripped, as the JAX loader's ``astype(str).str.strip()`` does, so an
integer column gives "7" and a float column "7.0" there as here.
"""
from __future__ import annotations

import csv

import numpy as np

from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
from recsys_tpu_torch.data.table import typed_column

COLUMNS = [
    "age", "class_worker", "det_ind_code", "det_occ_code", "education",
    "wage_per_hour", "hs_college", "marital_stat", "major_ind_code",
    "major_occ_code", "race", "hisp_origin", "sex", "union_member",
    "unemp_reason", "full_or_part_emp", "capital_gains", "capital_losses",
    "stock_dividends", "tax_filer_stat", "region_prev_res",
    "state_prev_res", "det_hh_fam_stat", "det_hh_summ", "instance_weight",
    "mig_chg_msa", "mig_chg_reg", "mig_move_reg", "mig_same",
    "mig_prev_sunbelt", "num_emp", "fam_under_18", "country_father",
    "country_mother", "country_self", "citizenship", "own_or_self",
    "vet_question", "vet_benefits", "weeks_worked", "year", "income_50k",
]
DENSE_COLS = [
    "age", "wage_per_hour", "capital_gains", "capital_losses",
    "stock_dividends", "num_emp", "weeks_worked",
]
DROP_COLS = ["instance_weight"]
LABEL_INCOME = "income_50k"
LABEL_MARITAL = "marital_stat"
SPARSE_COLS = [c for c in COLUMNS
               if c not in DENSE_COLS + DROP_COLS + [LABEL_INCOME, LABEL_MARITAL]]

def read_columns(path: str, names: list = COLUMNS) -> dict:
    """A headerless CSV file -> {name: column}, typed as ``pandas.read_csv(
    path, names=names)`` types them; blank lines are skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    bad = [i for i, r in enumerate(rows) if len(r) != len(names)]
    if bad:
        raise ValueError(f"{path}: row {bad[0] + 1} has {len(rows[bad[0]])} fields, "
                         f"expected {len(names)}")
    return {name: typed_column([r[j] for r in rows], name) for j, name in enumerate(names)}


def as_text(col: np.ndarray) -> np.ndarray:
    """A column's values as the stripped text pandas gives them
    (``astype(str).str.strip()``): "7" for an integer, "7.0" for a float."""
    if col.dtype.kind in "iu":
        return np.asarray([str(int(v)) for v in col])
    if col.dtype.kind == "f":
        return np.asarray([str(float(v)) for v in col])
    return np.asarray([str(v).strip() for v in col])


def create_census_dataset(train_path: str, test_path: str, embed_dim: int = 8,
                          seed: int = 2020):
    """``build_census_arrays`` of the census-income train and test files."""
    return build_census_arrays(read_columns(train_path), read_columns(test_path), embed_dim,
                               seed)


def build_census_arrays(train: dict, test: dict, embed_dim: int = 8, seed: int = 2020):
    """(schema, train, val, test) from the train and test columns: each
    split {'dense': (B, 7) f32, 'sparse': (B, 32) int32, 'label_income',
    'label_marital': (B,) f32}; the test rows split 1:1 into val and test
    by a permutation from ``seed``."""
    n_train = len(train[LABEL_INCOME])
    cols = {c: np.concatenate([train[c], test[c]]) for c in COLUMNS}
    y_income = np.char.find(as_text(cols[LABEL_INCOME]), "50000+") >= 0
    y_marital = as_text(cols[LABEL_MARITAL]) == "Never married"
    sparse = np.empty((len(y_income), len(SPARSE_COLS)), np.int32)
    vocab = []
    for j, c in enumerate(SPARSE_COLS):
        uniq, sparse[:, j] = np.unique(as_text(cols[c]), return_inverse=True)
        vocab.append(len(uniq))
    dense = np.stack([cols[c].astype(np.float32) for c in DENSE_COLS], axis=1)
    mn, mx = dense.min(axis=0), dense.max(axis=0)
    dense = (dense - mn) / np.where(mx > mn, mx - mn, 1.0)
    schema = FeatureSchema(
        dense=[DenseFeature(c) for c in DENSE_COLS],
        sparse=[SparseFeature(c, int(v), embed_dim) for c, v in zip(SPARSE_COLS, vocab)])

    def pack(sel):
        return {"dense": dense[sel], "sparse": sparse[sel],
                "label_income": y_income[sel].astype(np.float32),
                "label_marital": y_marital[sel].astype(np.float32)}

    rest = np.random.default_rng(seed).permutation(np.arange(n_train, len(y_income)))
    half = len(rest) // 2
    return schema, pack(np.arange(n_train)), pack(rest[:half]), pack(rest[half:])


def write_columns(path: str, cols: dict, names: list = COLUMNS) -> None:
    """Write ``cols`` as a headerless CSV file in ``names``' order, as the
    JAX runner's ``DataFrame.to_csv(index=False, header=False)`` does."""
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(zip(*(cols[c] for c in names)))
