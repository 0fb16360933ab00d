"""Delimited text files read into typed numpy columns as ``pandas.read_csv``
reads them, for the port's loaders, which run without pandas.

``typed_column`` is the typing rule: int64 where every field is an
integer, float64 where every field is a number (or where an integer
column has a gap), else the fields' text as they stand.  ``read_table``
reads a file with a header, or with the column names given, into such
columns.
"""
from __future__ import annotations

import csv
import re

import numpy as np

# the fields pandas.read_csv reads as missing by default
NA_FIELDS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
INT_FIELD = re.compile(r"\s*[+-]?[0-9]+\s*")
FLOAT_FIELD = re.compile(r"\s*[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?\s*")
INF_FIELD = re.compile(r"\s*[+-]?(inf|infinity)\s*", re.IGNORECASE)


def typed_column(fields: list, name: str, missing: str = "raise") -> np.ndarray:
    """One column's fields -> int64, float64 or the fields as objects, the
    type ``pandas.read_csv`` infers.  A field pandas reads as missing
    raises with ``missing='raise'`` (a census column has none); with
    ``missing='nan'`` it is NaN in a numeric column, which is then float64
    (as pandas makes an integer column with a gap), and None among text.
    An integer outside int64 and an infinity, which pandas reads in ways
    this rule does not mirror, raise."""
    gaps = [f in NA_FIELDS for f in fields]
    if any(gaps) and missing == "raise":
        raise ValueError(f"column {name!r}: a missing field in data row {gaps.index(True) + 1}")
    present = [f for f, gap in zip(fields, gaps) if not gap]
    if any(INF_FIELD.fullmatch(f) for f in present):
        raise ValueError(f"column {name!r}: an infinity, which this reader does not type "
                         "as pandas does")
    if not any(gaps) and all(INT_FIELD.fullmatch(f) for f in fields):
        ints = [int(f) for f in fields]
        if not all(-2**63 <= v < 2**63 for v in ints):
            raise ValueError(f"column {name!r}: an integer outside int64, which this reader "
                             "does not type as pandas does")
        return np.asarray(ints, np.int64)
    if all(FLOAT_FIELD.fullmatch(f) for f in present):  # all missing: float64 of NaN
        out = np.full(len(fields), np.nan)
        out[~np.asarray(gaps, bool)] = [float(f) for f in present]
        return out
    return np.asarray([None if gap else f for f, gap in zip(fields, gaps)], object)


def read_table(path: str, sep: str = ",", names: list | None = None,
               usecols: list | None = None, encoding: str = "utf-8",
               nrows: int | None = None) -> dict:
    """{column name: typed column} of a delimited file, as
    ``pandas.read_csv(path, sep=sep, names=names, usecols=usecols,
    encoding=encoding, nrows=nrows)`` reads it: the first line is the
    header unless ``names`` is given (then ``usecols`` may pick the
    positions they name), blank lines are skipped, a short row's missing
    fields are missing; a row longer than the columns raises."""
    with open(path, newline="", encoding=encoding) as f:
        reader = csv.reader(f, delimiter=sep)
        if names is None:
            names = next((r for r in reader if r), None)
            if not names:
                raise ValueError(f"{path}: no header line")
        width = len(names) if usecols is None else None
        pick = range(len(names)) if usecols is None else list(usecols)
        if len(pick) != len(names):
            raise ValueError(f"{len(pick)} columns picked for {len(names)} names")
        rows = []
        for r in reader:
            if nrows is not None and len(rows) == nrows:
                break
            if not r:
                continue
            if width is not None and len(r) > width:
                raise ValueError(f"{path}: data row {len(rows) + 1} has {len(r)} fields, "
                                 f"expected {width}")
            rows.append([r[j] if j < len(r) else "" for j in pick])
    return {name: typed_column([r[j] for r in rows], name, missing="nan")
            for j, name in enumerate(names)}
