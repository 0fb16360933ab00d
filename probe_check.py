"""How the probe kernels are held against their plain versions, shared by
chip_smoke.py and tests/test_torch_cuda.py (imports no JAX).

All three limits are exact: the kernel's output must equal the plain
version's bit for bit.
* ``adam_stream`` (#11) rounds each operation once (round-to-nearest
  intrinsics, no FMA contraction), as the plain version's separate torch
  operations do; over every table of a pass, p, m and v must change in
  place and g must not.
* ``perrow_walk`` (#12) adds the rows in the same serial order.
* ``hot_gather`` (#13) copies f32 rows, and gives +0 for every id outside
  [0, H·pack).
Each limit must also reject wrong results: a stale m, an unmoved p or a
pass that skips its last table; the sum without its last row; a row off
by one or a sentinel gathered as a clamped row.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import probes as probe_ref
from recsys_tpu_torch.kernels.dispatch import ADAM_PASS_TABLES

# name -> the tables of one pass, each (n elements, the state, element
# offset of its views: 1 misaligns them and takes the kernel's scalar path).
# One table is the one-table step; the passes: the probe's 26 bench tables
# (one launch), unequal tables with a misaligned one and a 3-element one,
# a pass holding an empty table, and 40 tables (two launches of 32 and 8).
ADAM_CASES = {
    "ragged 1001x16, probe state": [(1001 * 16, "probe", 0)],
    "ragged 1001x16, random state": [(1001 * 16, "random", 0)],
    "one bench table 100000x16, probe state": [(100_000 * 16, "probe", 0)],
    "one bench table 100000x16, random state": [(100_000 * 16, "random", 0)],
    "misaligned 16015, random state": [(1001 * 16 - 1, "random", 1)],
    "pass of the 26 bench tables, probe state": [(100_000 * 16, "probe", 0)] * 26,
    "pass of unequal tables, one misaligned": [(1001 * 16, "random", 0), (4099, "random", 0),
                                               (1001 * 16 - 1, "random", 1),
                                               (100_000 * 16, "random", 0), (3, "random", 0)],
    "pass with an empty table": [(4096, "random", 0), (0, "random", 0),
                                 (1001 * 16 - 2, "random", 0)],
    "pass of 40 tables, two launches": [(997 + 13 * i, "random", int(i % 3 == 0))
                                        for i in range(40)],
}
# name -> (n rows, W, element offset of x): the probe's block, a count that
# is not a whole number of staged chunks nor of 64-row groups, a width that
# is not a multiple of 4 (a last block of 2 columns) and an x that is not
# 16-byte aligned (their names are test ids), one row, one column, the
# widest block (256 column slices) and a walk past the 50 MB L2
PERROW_CASES = {"probe 8192x128": (8192, 128, 0), "ragged 1000x128": (1000, 128, 0),
                "ragged 1000x130, 4-byte copies": (1000, 130, 0),
                "misaligned 777x128, 4-byte copies": (777, 128, 1),
                "one row 1x128": (1, 128, 0), "one column 8192x1": (8192, 1, 0),
                "widest 2048x1024": (2048, 1024, 0),
                "past the L2 100000x128": (100_000, 128, 0)}
# name -> (H, pack, d, ids, kind): the probe's pack 1 (64 KB, past 48 KB),
# the JAX test's pack 8, a width with 4-byte copies, a 128 KB buffer; then
# unpadded ids ("flat": counts that are not whole 8-row warps, and grids of
# 1,563 and 4,688 blocks), ids mostly outside the buffer, a buffer 4 bytes
# into its storage (4-byte copies) and a buffer of exactly the H100's
# opt-in shared memory (232,448 bytes)
HOT_CASES = {"pack 1 H=1024 d=16": (1024, 1, 16, 13_312, "probe"),
             "pack 8 H=128 d=16": (128, 8, 16, 2048, "probe"),
             "pack 1 H=64 d=5": (64, 1, 5, 1000, "probe"),
             "pack 2 H=1024 d=16": (1024, 2, 16, 4096, "probe"),
             "13 ids": (1024, 1, 16, 13, "flat"),
             "1001 ids": (1024, 1, 16, 1001, "flat"),
             "100003 ids": (1024, 1, 16, 100_003, "flat"),
             "300001 ids": (1024, 1, 16, 300_001, "flat"),
             "mostly outside": (1024, 1, 16, 4099, "outside"),
             "unaligned buffer": (1024, 1, 16, 13_312, "unaligned"),
             "buffer at the opt-in limit H=3632": (3632, 1, 16, 13_312, "probe")}
HOT_TOO_BIG = (4096, 1, 16)  # 256 KB: beyond the H100's 227 KB


def bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape and the same f32 bit patterns."""
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def _result(got: dict, want: dict, wrong: dict) -> dict:
    """{'bit_equal', 'max_abs_err', 'wrong_rejected': {fault: rejected}} of
    named outputs ``got`` against ``want``; ``wrong`` maps a fault to its
    wrong outputs."""
    def passes(out):
        return all(bits_equal(out[k], want[k]) for k in want)

    return {"bit_equal": passes(got),
            "max_abs_err": max(max_abs_err(got[k], want[k]) for k in want),
            "wrong_rejected": {name: not passes(out) for name, out in wrong.items()}}


def adam_inputs(rng, n: int, state: str) -> list[np.ndarray]:
    """p, m, v, g (n,) f32: the probe's state (m = v = 0, g ~ 1e-3) or a
    random one."""
    p = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    if state == "probe":
        m, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    else:
        m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
        v = (rng.random(n) * 1e-6).astype(np.float32)
    return [p, m, v, g]


def launches_of(tables) -> int:
    """Launches the card's pass makes over ``tables``: one for every
    ``ADAM_PASS_TABLES`` nonempty tables."""
    return -(-sum(1 for n, _, _ in tables if n) // ADAM_PASS_TABLES)


def check_adam(pass_, rng, tables, device) -> dict:
    """``pass_(ps, ms, vs, gs)`` (in place) over the tables of one pass
    against the plain step on each table's same inputs; each table's
    tensors are views ``offset`` elements into their storage."""
    quads = [[torch.from_numpy(a).to(device)[offset:] for a in adam_inputs(rng, n + offset,
                                                                          state)]
             for n, state, offset in tables]
    before = [[t.clone() for t in q] for q in quads]
    ptrs = [t.data_ptr() for q in quads for t in q]
    pass_(*(list(ts) for ts in zip(*quads)))
    got, want, old = {}, {}, {}
    for k, (q, b) in enumerate(zip(quads, before)):
        plain = [t.clone() for t in b]
        probe_ref.adam_stream_step_(*plain)
        for name, g_, w_, o_ in zip("pmv", q, plain, b):
            got[f"{name}{k}"], want[f"{name}{k}"], old[f"{name}{k}"] = g_, w_, o_
    last = max(k for k, (n, _, _) in enumerate(tables) if n)
    wrong = {"stale m": {**want, **{k: o for k, o in old.items() if k[0] == "m"}},
             "p not updated": {**want, **{k: o for k, o in old.items() if k[0] == "p"}},
             "last table not updated": {**want, **{f"{c}{last}": old[f"{c}{last}"]
                                                   for c in "pmv"}}}
    res = _result(got, want, wrong)
    res["in_place"] = [t.data_ptr() for q in quads for t in q] == ptrs and all(
        not bits_equal(t, o) for q, b in zip(quads, before) if q[0].numel()
        for t, o in zip(q[:3], b[:3]))
    res["g_unchanged"] = all(bits_equal(q[3], b[3]) for q, b in zip(quads, before))
    return res


def check_perrow(colsum, rng, n: int, w: int, offset: int, device) -> dict:
    """``colsum(x)`` on an (n, w) f32 block, ``offset`` elements into its
    storage, against the serial plain sum."""
    flat = rng.standard_normal(n * w + offset).astype(np.float32)
    x = torch.from_numpy(flat).to(device)[offset:].view(n, w)
    want = probe_ref.perrow_colsum(x)
    wrong = probe_ref.perrow_colsum(x[:-1]) if n > 1 else torch.zeros_like(want)
    return _result({"out": colsum(x)}, {"out": want},
                   {"sum without the last row": {"out": wrong}})


def hot_inputs(rng, h: int, pack: int, d: int, n: int, kind: str, device):
    """hot (H, pack·d) f32 and int64 ids.  "probe": (ceil(n / 256), 256)
    hot slot ids with, in every 16th place, a sentinel H·pack, a negative
    id or an id far past the buffer (one beyond int32), and sentinel
    padding after the n-th; "flat": the same n ids unpadded; "outside": n
    ids of which 7 in 8 lie outside; "unaligned": the probe's ids, and a
    buffer that starts 4 bytes into its storage."""
    offset = int(kind == "unaligned")
    flat = rng.uniform(-1, 1, h * pack * d + offset).astype(np.float32)
    hot = torch.from_numpy(flat).to(device)[offset:].view(h, pack * d)
    rows = h * pack
    ids = rng.integers(0, rows, n).astype(np.int64)
    outside = np.array([rows, -1, -rows, rows + 7, -(2 ** 31), 2 ** 32 + 5], np.int64)
    every = 16 if kind != "outside" else 1
    at = np.arange(n)[::every]
    if kind == "outside":
        at = at[at % 8 != 3]
    ids[at] = outside[np.arange(len(at)) % len(outside)]
    if kind == "flat" or kind == "outside":
        return hot, torch.from_numpy(ids).to(device)
    padded = np.full(-(-n // 256) * 256, rows, np.int64)
    padded[:n] = ids
    return hot, torch.from_numpy(padded.reshape(-1, 256)).to(device)


def check_hot(gather, rng, h: int, pack: int, d: int, n: int, kind: str, device) -> dict:
    """``gather(hot, ids, pack)`` against the plain gather, on the int64 ids
    and on them clamped into int32; ids outside [0, H·pack) must give zero
    rows."""
    hot, ids = hot_inputs(rng, h, pack, d, n, kind, device)
    ids32 = ids.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)
    want = probe_ref.hot_gather(hot, ids, pack)
    flat = ids.reshape(-1)
    rows = h * pack
    off_by_one = probe_ref.hot_gather(hot, torch.where((flat >= 0) & (flat < rows),
                                                       (flat + 1) % rows, flat), pack)
    clamped = hot.reshape(rows, d).index_select(0, flat.clamp(0, rows - 1))
    return _result({"int64": gather(hot, ids, pack), "int32": gather(hot, ids32, pack)},
                   {"int64": want, "int32": want},
                   {"a row off by one": {"int64": off_by_one, "int32": off_by_one},
                    "sentinels gathered as clamped rows": {"int64": clamped,
                                                           "int32": clamped}})


def passed(res: dict) -> bool:
    """Every limit held and every wrong result rejected."""
    return (res["bit_equal"] and all(res["wrong_rejected"].values())
            and res.get("in_place", True) and res.get("g_unchanged", True))
