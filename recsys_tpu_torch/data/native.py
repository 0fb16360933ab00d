"""The Criteo parser of the port (the counterpart of the parser part of
``recsys_tpu/data/native.py``): ``csrc/criteo_parse.cc`` built with ``g++``
at first use and called through ctypes.

The library goes to ``build/recsys_tpu_torch/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one reused.  There is no Python parse: with no
compiler, or a failed build, every entry point raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "criteo_parse.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recsys_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
DEFAULT_BUCKETS = 1 << 20

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:12]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the parser; raises with the compiler's
    output when it cannot."""
    out = library_path()
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX) to build the Criteo parser")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(out))
    lib.parse_criteo.restype = ctypes.c_int64
    lib.parse_criteo.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, _F32P, _F32P, _I32P]
    lib.parse_criteo_chunk.restype = ctypes.c_int64
    lib.parse_criteo_chunk.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _F32P,
                                       _F32P, _I32P, ctypes.POINTER(ctypes.c_int64)]
    return lib


def detect_format(path: str) -> tuple[str, bool]:
    """(sep, skip_header) of a Criteo file from its first line: tab when it
    holds a tab, else comma; a header when it starts with ``label``."""
    with open(path, "rb") as f:
        first = f.readline().decode(errors="replace")
    return ("\t" if "\t" in first else ","), first.lower().lstrip().startswith("label")


def new_buffers(rows: int) -> tuple:
    """Zeroed (labels (R,) f32, dense (R, 13) f32, sparse (R, 26) int32)."""
    return (np.zeros(rows, np.float32), np.zeros((rows, 13), np.float32),
            np.zeros((rows, 26), np.int32))


def parse_criteo(path: str, sep: str = ",", max_rows: int = 1 << 40,
                 cat_buckets: int = DEFAULT_BUCKETS, skip_header: bool = True):
    """(labels (N,), dense (N, 13) raw values, sparse (N, 26) hashed ids) of
    a Criteo file, at most ``max_rows`` rows."""
    lib = library()
    with open(path, "rb") as f:
        cap = min(max_rows, sum(1 for _ in f))
    labels, dense, sparse = new_buffers(cap)
    n = lib.parse_criteo(str(path).encode(), sep.encode(), cap, cat_buckets,
                         1 if skip_header else 0, labels.ctypes.data_as(_F32P),
                         dense.ctypes.data_as(_F32P), sparse.ctypes.data_as(_I32P))
    if n < 0:
        raise OSError(f"cannot open {path}")
    return labels[:n], dense[:n], sparse[:n]


def parse_criteo_chunk(path: str, offset: int, max_rows: int, *, sep: str = ",",
                       cat_buckets: int = DEFAULT_BUCKETS, skip_header: bool = True,
                       out: tuple | None = None):
    """Up to ``max_rows`` rows from byte ``offset``: ((labels, dense, sparse)
    views of ``out``, or of new buffers, cut to the rows parsed, the offset
    to resume from).  At the end of the file: 0 rows and the same offset."""
    lib = library()
    labels, dense, sparse = new_buffers(max_rows) if out is None else out
    if len(labels) < max_rows:
        raise ValueError(f"buffers of {len(labels)} rows for a chunk of {max_rows}")
    next_off = ctypes.c_int64(0)
    n = lib.parse_criteo_chunk(str(path).encode(), sep.encode(), offset, max_rows, cat_buckets,
                               1 if skip_header else 0, labels.ctypes.data_as(_F32P),
                               dense.ctypes.data_as(_F32P), sparse.ctypes.data_as(_I32P),
                               ctypes.byref(next_off))
    if n < 0:
        raise OSError(f"cannot open or seek {path} at {offset}")
    return (labels[:n], dense[:n], sparse[:n]), int(next_off.value)
