"""Zipf hot/cold split of the forward gather, measured (the port of
``recsys_tpu/tools/gather_split_probe.py``).

The host already counts each batch's ids; the probe asks whether gathering
the most frequent rows from a staged hot buffer beats the plain gather:

  full   -- the port's production gather: one ``index_select`` per logical
            (100,000, 16) f32 table, as ``StackedEmbedding`` gathers.
  split  -- stage the top-H rows of each table (``index_select``), gather
            the hot ids from them with the hot-gather kernel
            (``dispatch.hot_gather``, the rows read through L2), gather
            the cold ids from the table, and put both back in batch order.
            Every step is timed.

At the bench shapes (26 tables, B = 16384) with Zipf(1.1) ids or, with
``--uniform``, the bench's uniform ids (where a hot split cannot help).
The port's tables are logical, so a hot row is one id (``pack`` 1); the JAX
probe's hot rows were 128-lane physical rows of 8 ids.

Run: python -m recsys_tpu_torch.tools.gather_split_probe [--zipf 1.1] [--hot 1024]
        [--uniform] [--iters 30] [--seed 0] [--device cpu] [--out FILE]
One JSON object on stdout (and appended to ``--out``), a summary on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.tools.roofline import BATCH, EMBED_DIM, NUM_SPARSE, VOCAB, card, timer

NUM_TABLES = NUM_SPARSE
D = EMBED_DIM
CH = 256  # ids per hot-gather chunk


def _zipf_ids(rng, s: float, n: int, vocab: int = VOCAB) -> np.ndarray:
    """``n`` ids of a Zipf(s) law over ranks, mapped through a permutation
    (ids are hash-like, not rank-ordered): the JAX probe's draw."""
    p = 1.0 / np.arange(1, vocab + 1) ** s
    p /= p.sum()
    perm = rng.permutation(vocab)
    return perm[rng.choice(vocab, size=n, p=p)].astype(np.int32)


def host_split(ids: np.ndarray, hot_n: int, pack: int = 1):
    """Per-table host prep: the top-``hot_n`` rows (of ``pack`` ids each) by
    batch count.

    Returns (hot_rows (hot_n,), hot_idx2d (nc, CH) int32 hot slot ids
    ``slot·pack + id % pack`` padded with the sentinel ``hot_n·pack``,
    positions (n,) int32, each batch position's row in concat(hot rows,
    cold rows), cold_ids, n_hot, n_cold)."""
    prow = ids // pack
    counts = np.bincount(prow, minlength=VOCAB // pack + 1)
    hot_rows = np.argsort(-counts, kind="stable")[:hot_n].astype(np.int32)
    hot_slot_of = np.full(counts.shape[0], -1, np.int32)
    hot_slot_of[hot_rows] = np.arange(hot_n, dtype=np.int32)
    slot = hot_slot_of[prow]
    is_hot = slot >= 0
    hot_pos = np.nonzero(is_hot)[0].astype(np.int32)
    cold_pos = np.nonzero(~is_hot)[0].astype(np.int32)
    n_hot = len(hot_pos)
    nc = -(-n_hot // CH)
    sentinel = np.int32(hot_n * pack)
    hot_idx = np.full(nc * CH, sentinel, np.int32)
    hot_idx[:n_hot] = slot[hot_pos] * pack + (ids[hot_pos] % pack)
    cold_ids = ids[cold_pos]
    positions = np.concatenate([hot_pos, cold_pos])
    inv = np.empty_like(positions)
    inv[positions] = np.arange(len(positions), dtype=np.int32)
    return (hot_rows, hot_idx.reshape(nc, CH), inv, cold_ids,
            n_hot, len(cold_pos))


def run(*, device, generator, rng, hot: int = 1024, zipf: float = 1.1, uniform: bool = False,
        iters: int = 30, tables: int = NUM_TABLES, vocab: int = VOCAB, dim: int = D,
        batch: int = BATCH) -> dict:
    """Time the full and the split gather over ``tables`` tables; ids from
    the numpy ``rng``, tables from ``generator``."""
    tabs = [torch.rand((vocab, dim), generator=generator, device=device) * 0.1 - 0.05
            for _ in range(tables)]
    if uniform:
        ids_np = [rng.integers(0, vocab, batch).astype(np.int32) for _ in range(tables)]
    else:
        ids_np = [_zipf_ids(rng, zipf, batch, vocab) for _ in range(tables)]
    ids = [torch.from_numpy(a).long().to(device) for a in ids_np]
    preps = [host_split(a, hot) for a in ids_np]
    hot_rows = [torch.from_numpy(pr[0]).long().to(device) for pr in preps]
    hot_idx = [torch.from_numpy(pr[1]).to(device) for pr in preps]
    invs = [torch.from_numpy(pr[2]).long().to(device) for pr in preps]
    cold_ids = [torch.from_numpy(pr[3]).long().to(device) for pr in preps]

    def full():
        return [t.index_select(0, i) for t, i in zip(tabs, ids)]

    def split():
        out = []
        for g, t in enumerate(tabs):
            hot_buf = t.index_select(0, hot_rows[g])  # (hot, dim): pack 1
            hot_out = dispatch.hot_gather(hot_buf, hot_idx[g], pack=1)
            both = torch.cat([hot_out[:preps[g][4]], t.index_select(0, cold_ids[g])])
            out.append(both.index_select(0, invs[g]))  # back in batch order
        return out

    time_ms = timer(device)
    ms_full = time_ms(full, iters, 3)
    ms_split = time_ms(split, iters, 3)
    err = max(float((a - b).abs().max()) for a, b in zip(split(), full()))
    return {"batch": batch, "tables": tables, "hot_rows": hot, "pack": 1,
            "distribution": "uniform" if uniform else f"zipf({zipf})",
            "hot_coverage": float(np.mean([pr[4] / batch for pr in preps])),
            "full_ms": ms_full, "split_ms": ms_split, "speedup": ms_full / ms_split,
            "max_abs_err": err}


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) shrinks the probe:
    ``tables``, ``vocab``, ``dim``, ``batch``."""
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.gather_split_probe")
    p.add_argument("--zipf", type=float, default=1.1)
    p.add_argument("--hot", type=int, default=1024)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--uniform", action="store_true",
                   help="use the bench's uniform ids instead of Zipf")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None, help="append the JSON line here")
    args = p.parse_args(argv)
    device = default_device(args.device)
    on_card = device.type == "cuda"
    rep = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "nvidia_smi": card()["smi"] if on_card else None,
           "timer": "cuda events" if on_card else "host clock"}
    rep.update(run(device=device, generator=torch.Generator(device=device).manual_seed(args.seed),
                   rng=np.random.default_rng(args.seed), hot=args.hot, zipf=args.zipf,
                   uniform=args.uniform, iters=args.iters, **sizes))
    sys.stderr.write(f"{rep}\n")
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "a") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()
