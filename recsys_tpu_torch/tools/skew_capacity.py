"""The a2a engine's capacity factor under id skew, measured (the port of
``recsys_tpu/tools/skew_capacity.py``).

The vector exchange moves ``capacity_factor · N · D`` bytes each way
(``tools/comm_bytes.py``), so the smallest capacity factor with no id
dropped is the engine's wire cost under that traffic.  Skew makes the
owners' buckets uneven, and dedup collapses the hot ids before bucketing.
Each rank of a (data, model) world looks its data shard's ids up through
``sharded_gather_a2a(..., return_stats=True)`` and reads the ids dropped
over the whole world, for uniform and Zipf(1.1) ids
(``dedup_probe.zipf_ids``), dedup off and on, and capacity factors 0.25 to
2.0.  The table and ids come from numpy's generator at ``--seed`` in the
JAX tool's order, so the drops, which follow from the ids alone, are the
JAX tool's at the same mesh under the same numpy (its Zipf sampler draws
other values in other versions; the report names the version).

Run: python -m recsys_tpu_torch.tools.skew_capacity [--data 2] [--model 4]
        [--batch 4096] [--vocab 100000] [--device cpu] [--out FILE]
One JSON object on stdout, a line a case on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.parallel import embedding_sharding as es
from recsys_tpu_torch.parallel.mesh import make_mesh
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools.comm_bytes import backend_for
from recsys_tpu_torch.tools.dedup_probe import zipf_ids
from recsys_tpu_torch.tools.mesh_check import data_rows

VOCAB = 100_000
EMBED_DIM = 16
BATCH = 4096
FIELDS = 8
CAPACITY_FACTORS = (0.25, 0.5, 0.75, 1.0, 1.25, 2.0)


def inputs(batch: int = BATCH, vocab: int = VOCAB, fields: int = FIELDS, seed: int = 0):
    """(table (vocab, 16) f32, {'uniform', 'zipf': (batch, fields) int32
    ids}), drawn in the JAX tool's order."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.05, 0.05, (vocab, EMBED_DIM)).astype(np.float32)
    ids = {"uniform": rng.integers(0, vocab, (batch, fields)).astype(np.int32),
           "zipf": np.stack([zipf_ids(rng, batch, vocab) for _ in range(fields)], axis=1)}
    return table, ids


def rank_drops(shape, table: np.ndarray, ids: dict, cfs=CAPACITY_FACTORS,
               device: str = "cpu") -> list:
    """On one rank of a world of ``shape``: [(dist, dedup, cf, dropped)],
    the ids dropped over the world by each case's lookup."""
    mesh = make_mesh(*shape, device=device)
    pad = (-table.shape[0]) % shape[1]
    full = torch.from_numpy(np.pad(table, ((0, pad), (0, 0)))).to(device)
    shard = es.shard_table(full, mesh)
    out = []
    for dist, arr in ids.items():
        rows = torch.from_numpy(data_rows(mesh, arr)).to(device)
        for dedup in (False, True):
            for cf in cfs:
                _, dropped = es.sharded_gather_a2a(shard, rows, mesh, capacity_factor=cf,
                                                   dedup=dedup, return_stats=True)
                out.append((dist, dedup, cf, int(dropped)))
    return out


def summarize(drops: list, ids: dict, n: int) -> tuple:
    """(results rows, {'{dist}_dedup{0|1}_min_zero_drop_cf': cf or None})."""
    results = [{"dist": dist, "dedup": dedup, "cf": cf, "dropped": d, "dropped_frac": d / n}
               for dist, dedup, cf, d in drops]
    summary = {}
    for dist in ids:
        for dedup in (False, True):
            zero = [r["cf"] for r in results
                    if r["dist"] == dist and r["dedup"] == dedup and r["dropped"] == 0]
            summary[f"{dist}_dedup{int(dedup)}_min_zero_drop_cf"] = min(zero) if zero else None
    return results, summary


def run(shape=(2, 4), batch: int = BATCH, vocab: int = VOCAB, seed: int = 0, *,
        device) -> dict:
    table, ids = inputs(batch, vocab, FIELDS, seed)
    backend = backend_for(device, shape[0] * shape[1])
    ranks = spawn(rank_drops, shape[0] * shape[1], shape, table, ids, CAPACITY_FACTORS,
                  device.type, device=device.type, backend=backend)
    return report(ranks, shape, batch, vocab, seed, ids, backend, device)


def report(ranks: list, shape, batch: int, vocab: int, seed: int, ids: dict, backend: str,
           device) -> dict:
    """The tool's report from every rank's ``rank_drops`` over ``ids``."""
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError(f"skew_capacity: the ranks' counts differ: {ranks}")
    n = batch * FIELDS
    results, summary = summarize(ranks[0], ids, n)
    for r in results:
        sys.stderr.write(f"[{r['dist']}] dedup={int(r['dedup'])} cf={r['cf']:4}: dropped "
                         f"{r['dropped']}/{n} ({100 * r['dropped_frac']:.2f}%)\n")
    return {"mesh": {"data": shape[0], "model": shape[1]}, "batch": batch, "fields": FIELDS,
            "vocab": vocab, "seed": seed, "numpy": np.__version__, "lookups_per_step": n,
            "backend": backend,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "unique_ids": {dist: int(np.unique(a).shape[0]) for dist, a in ids.items()},
            "results": results, "min_zero_drop_cf": summary}


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.skew_capacity")
    p.add_argument("--data", type=int, default=2)
    p.add_argument("--model", type=int, default=4)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--vocab", type=int, default=VOCAB)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run((args.data, args.model), args.batch, args.vocab, args.seed,
              device=default_device(args.device))
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()
