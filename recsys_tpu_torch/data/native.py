"""The port's native host library (the counterpart of
``recsys_tpu/data/native.py``): the Criteo parser (``csrc/criteo_parse.cc``),
the negative sampler, the SASRec leave-last-2 builder, the shuffle and the
fused embedding update's host prep (``csrc/sample_prep.cc``), built with
``g++`` into one library at first use and called through ctypes, which
releases the interpreter lock for the length of each call.

The library goes to ``build/recsys_tpu_torch/`` at the root of the
checkout, named by a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one reused.  Nothing here has a Python fallback:
with no compiler, or a failed build, every entry point raises.
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
PREP_SOURCE = SOURCE.with_name("sample_prep.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recsys_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
DEFAULT_BUCKETS = 1 << 20

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32, _I64 = ctypes.c_int32, ctypes.c_int64


def library_path() -> Path:
    sources = (SOURCE, PREP_SOURCE)
    digest = hashlib.sha1(b"".join(s.read_bytes() for s in sources)
                          + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"recsys_native-{digest.hexdigest()[:12]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises with the compiler's
    output when it cannot."""
    out = library_path()
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX) to build the native library")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), str(PREP_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} and {PREP_SOURCE.name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(out))
    lib.parse_criteo.restype = ctypes.c_int64
    lib.parse_criteo.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, _F32P, _F32P, _I32P]
    lib.parse_criteo_chunk.restype = ctypes.c_int64
    lib.parse_criteo_chunk.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _F32P,
                                       _F32P, _I32P, _I64P]
    lib.sample_negatives.restype = ctypes.c_int
    lib.sample_negatives.argtypes = [_I64, _I32, _I32, _I32, _I32P, _I64P, ctypes.c_uint64,
                                     _I32P]
    lib.build_seq_leave_last2.restype = ctypes.c_int
    lib.build_seq_leave_last2.argtypes = [_I32P, _I64P, _I64, _I32, _I32, _I32,
                                          ctypes.c_uint64, ctypes.c_int, *[_I32P] * 9, _I64P]
    lib.shuffle_indices.restype = None
    lib.shuffle_indices.argtypes = [_I64, ctypes.c_uint64, _I64P]
    lib.fused_prep.restype = ctypes.c_int
    lib.fused_prep.argtypes = [_I32P, _I64, _I32, _I32, _I32, _I32, _I32P, _I32P, _I32P]
    # fused_prep_group writes into caller-owned buffers, pinned host memory
    # among them: its outputs are plain addresses
    lib.fused_prep_group.restype = ctypes.c_int
    lib.fused_prep_group.argtypes = [_I32P, _I64, _I32, _I32P, _I32P, _I32, _I32, _I32,
                                     _I32, _I32, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
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


def sample_negatives(exclusions: list, n_neg: int, lo: int, hi: int,
                     seed: int = 0) -> np.ndarray:
    """(len(exclusions), n_neg) int32 uniform draws from [lo, hi), row i's
    never in ``exclusions[i]``: the JAX ``sample_negatives``' stream, a
    PCG32 stream a row."""
    if hi <= lo:
        raise ValueError(f"empty range [{lo}, {hi})")
    lib = library()
    lists = [np.asarray(e, np.int32).reshape(-1) for e in exclusions]
    off = np.zeros(len(lists) + 1, np.int64)
    off[1:] = np.cumsum([len(e) for e in lists])
    flat = np.concatenate(lists) if off[-1] else np.zeros(1, np.int32)
    out = np.zeros((len(lists), n_neg), np.int32)
    if lib.sample_negatives(len(lists), n_neg, lo, hi, flat.ctypes.data_as(_I32P),
                            off.ctypes.data_as(_I64P), seed, out.ctypes.data_as(_I32P)):
        raise ValueError(f"an exclusion list covers [{lo}, {hi}): no negative to draw")
    return out


def build_seq_leave_last2(items: np.ndarray, user_off: np.ndarray, maxlen: int,
                          num_items: int, test_neg: int, seed: int = 0,
                          all_positions: bool = False):
    """The SASRec leave-last-2 rows of ``csrc/sample_prep.cc``: ``items``
    the 1-based item ids in (user, time) order, user u's at
    ``items[user_off[u]:user_off[u + 1]]``.  Returns the (train, val, test)
    dicts of ``data.movielens.build_sasrec_dataset`` (``hist``, ``pos``,
    ``neg``), its negatives from a PCG32 stream a user, as the JAX native
    builder draws them."""
    if num_items < 2:
        raise ValueError(f"num_items={num_items}: no item to draw a negative from")
    lib = library()
    items = np.ascontiguousarray(items, np.int32)
    user_off = np.ascontiguousarray(user_off, np.int64)
    n_users = len(user_off) - 1
    cap_tr = n_users if all_positions else len(items)
    width = maxlen if all_positions else 1
    bufs = [np.zeros((cap_tr, maxlen), np.int32), np.zeros((cap_tr, width), np.int32),
            np.zeros((cap_tr, width), np.int32)]
    for _ in range(2):  # val, test
        bufs += [np.zeros((n_users, maxlen), np.int32), np.zeros(n_users, np.int32),
                 np.zeros((n_users, test_neg), np.int32)]
    counts = np.zeros(2, np.int64)
    if lib.build_seq_leave_last2(items.ctypes.data_as(_I32P), user_off.ctypes.data_as(_I64P),
                                 n_users, maxlen, num_items, test_neg, seed,
                                 int(all_positions), *(b.ctypes.data_as(_I32P) for b in bufs),
                                 counts.ctypes.data_as(_I64P)):
        raise ValueError("a user's items cover every item: no negative to draw")
    nt, ne = int(counts[0]), int(counts[1])

    def split(h, p, n, rows):
        p = p[:rows]
        if p.ndim == 2 and p.shape[1] == 1:  # one target a row: (N,)
            p = p[:, 0]
        return {"hist": h[:rows], "pos": p, "neg": n[:rows]}

    return split(*bufs[:3], nt), split(*bufs[3:6], ne), split(*bufs[6:], ne)


def shuffle_indices(n: int, seed: int = 0) -> np.ndarray:
    """A permutation of [0, n) as int64, the JAX ``shuffle_indices``'
    Fisher-Yates from one PCG32 stream."""
    out = np.zeros(n, np.int64)
    library().shuffle_indices(n, seed, out.ctypes.data_as(_I64P))
    return out


def prep_geometry(n: int, vp: int, block: int, ch: int, shards: int = 1) -> tuple[int, int]:
    """(nc_max, nb): the static chunk count ``n // ch + nb`` of ``n`` ids
    in chunks of ``ch`` over the ``nb`` blocks of a table of ``vp`` rows,
    ``ceil(vp / shards / block)`` in each of its ``shards`` row shards."""
    if min(vp, block, ch) < 1:
        raise ValueError(f"vp={vp}, block={block} and ch={ch} must be positive")
    if shards < 1 or vp % shards:
        raise ValueError(f"vp={vp} not divisible by shards={shards}")
    nb = shards * -(-(vp // shards) // block)
    return n // ch + nb, nb


def fused_prep(ids: np.ndarray, vp: int, block: int, ch: int, shards: int = 1):
    """The fused update's host prep of one table of ``vp`` rows: (ids2d
    (nc_max, ch), idx (nc_max·ch,), cptr (nb + 1,)), all int32, bit-equal to
    the JAX ``fused_prep`` (and to ``train.streaming_embed.host_prep_group``)
    with the same ``shards``, whose block fences align to the row shards of
    a model axis.  Raises on an id outside [0, vp) or ``vp % shards``."""
    ids = np.ascontiguousarray(ids, np.int32)
    nc, nb = prep_geometry(len(ids), vp, block, ch, shards)
    ids2d, idx = np.empty((nc, ch), np.int32), np.empty(nc * ch, np.int32)
    cptr = np.empty(nb + 1, np.int32)
    if library().fused_prep(ids.ctypes.data_as(_I32P), len(ids), vp, block, ch, shards,
                            ids2d.ctypes.data_as(_I32P), idx.ctypes.data_as(_I32P),
                            cptr.ctypes.data_as(_I32P)):
        raise ValueError(f"ids outside [0, {vp})")
    return ids2d, idx, cptr


def fused_prep_group(sparse: np.ndarray, cols: np.ndarray, offs: np.ndarray, vp: int,
                     block: int, ch: int, ids2d: np.ndarray, src: np.ndarray,
                     cptr: np.ndarray, shards: int = 1) -> None:
    """``fused_prep`` of one table group of a (B, F) int32 batch, into the
    caller's int32 buffers: the group's ids are columns ``cols`` plus
    ``offs``, column after column, and ``src`` holds, where ``fused_prep``'s
    ``idx`` holds an occurrence, its row ``r·F + col`` of the (B·F, D) tap
    cotangent.  Raises on an id outside [0, vp)."""
    b, f = sparse.shape
    cols = np.ascontiguousarray(cols, np.int32)
    offs = np.ascontiguousarray(offs, np.int32)
    nc, nb = prep_geometry(b * len(cols), vp, block, ch, shards)
    if sparse.dtype != np.int32 or not sparse.flags.c_contiguous or \
            len(offs) != len(cols) or (len(cols) and not 0 <= cols.min() <= cols.max() < f):
        raise ValueError("sparse must be C-contiguous int32 (B, F), cols in [0, F), "
                         "one offset a column")
    for name, a, shape in (("ids2d", ids2d, (nc, ch)), ("src", src, (nc * ch,)),
                           ("cptr", cptr, (nb + 1,))):
        if a.dtype != np.int32 or a.shape != shape or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous int32 {shape}, got "
                             f"{a.dtype} {a.shape}")
    if library().fused_prep_group(sparse.ctypes.data_as(_I32P), b, f,
                                  cols.ctypes.data_as(_I32P), offs.ctypes.data_as(_I32P),
                                  len(cols), vp, block, ch, shards, ids2d.ctypes.data,
                                  src.ctypes.data, cptr.ctypes.data):
        raise ValueError(f"group ids outside [0, {vp})")
