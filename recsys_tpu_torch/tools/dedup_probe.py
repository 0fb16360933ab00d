"""Dedup before gather, measured (the port of
``recsys_tpu/tools/dedup_probe.py``): does fetching each field's unique
rows once, then expanding them to the batch, beat the plain gather?

At the bench shapes (26 fields, B = 16384, logical 100,000 x 16 f32 tables,
64-byte rows) under uniform and Zipf(1.1) ids, four variants:

* ``plain``        -- the production path: 26 x ``index_select(table, ids)``.
* ``uniq_only``    -- fetch each field's U unique rows only.
* ``expand_only``  -- the B-row inverse-map expansion from a (U, 16)
                      compact buffer (the second half of any dedup scheme).
* ``dedup_chain``  -- unique fetch and expansion chained (the full scheme).

The JAX probe deduplicated 512-byte physical rows of 8 ids; the port's
rows are logical, one id each.

Run: python -m recsys_tpu_torch.tools.dedup_probe [--iters 30] [--seed 0]
                                                  [--device cpu] [--out FILE]
One JSON object on stdout, a summary on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.tools.roofline import BATCH, EMBED_DIM, NUM_SPARSE, VOCAB, card, timer

B = BATCH
F = NUM_SPARSE


def zipf_ids(rng, n, vocab, a=1.1):
    """Zipf(a) ranks mapped through a random per-field vocab permutation
    (data/realistic.py's categorical model)."""
    r = rng.zipf(a, size=n * 4)
    r = r[r <= vocab][:n]
    while r.shape[0] < n:
        extra = rng.zipf(a, size=n)
        r = np.concatenate([r, extra[extra <= vocab]])[:n]
    perm = rng.permutation(vocab)
    return perm[r - 1].astype(np.int32)


def run(dist: str, iters: int, rng, *, device, generator, fields: int = F, batch: int = B,
        vocab: int = VOCAB, dim: int = EMBED_DIM) -> dict:
    """The four variants under ``dist`` ('uniform' or 'zipf') ids."""
    tables = [torch.rand((vocab, dim), generator=generator, device=device) * 0.1 - 0.05
              for _ in range(fields)]
    if dist == "uniform":
        ids = [rng.integers(0, vocab, batch).astype(np.int32) for _ in range(fields)]
    else:
        ids = [zipf_ids(rng, batch, vocab) for _ in range(fields)]
    uniq_inv = [np.unique(i, return_inverse=True) for i in ids]
    ucounts = [u.shape[0] for u, _ in uniq_inv]
    ucap = max(8, int(np.ceil(max(ucounts) / 256) * 256))
    uniq = []
    for u, _ in uniq_inv:
        padded = np.zeros(ucap, np.int64)
        padded[: u.shape[0]] = u
        uniq.append(torch.from_numpy(padded).to(device))
    ids_d = [torch.from_numpy(i).long().to(device) for i in ids]
    inv_d = [torch.from_numpy(inv.reshape(-1)).long().to(device) for _, inv in uniq_inv]
    compacts = [torch.randn((ucap, dim), generator=generator, device=device)
                for _ in range(fields)]

    variants = {
        "plain": lambda: [t.index_select(0, i) for t, i in zip(tables, ids_d)],
        "uniq_only": lambda: [t.index_select(0, u) for t, u in zip(tables, uniq)],
        "expand_only": lambda: [c.index_select(0, i) for c, i in zip(compacts, inv_d)],
        "dedup_chain": lambda: [t.index_select(0, u).index_select(0, i)
                                for t, u, i in zip(tables, uniq, inv_d)],
    }
    rows_of = {"plain": fields * batch, "uniq_only": fields * ucap,
               "expand_only": fields * batch, "dedup_chain": fields * (ucap + batch)}
    out = {"unique_rows_per_field": {"min": int(min(ucounts)), "mean": float(np.mean(ucounts)),
                                     "max": int(max(ucounts)), "of": batch}, "ucap": ucap}
    for name, fn in variants.items():
        ms = timer(device)(fn, iters, 3)
        out[name] = {"ms": ms, "rows": rows_of[name], "ns_per_row": ms * 1e6 / rows_of[name]}
        sys.stderr.write(f"[{dist}] {name:12s} {ms:9.4f} ms "
                         f"({out[name]['ns_per_row']:7.3f} ns/row)\n")
    got = variants["dedup_chain"]()
    out["max_abs_err"] = max(float((a - b).abs().max())
                             for a, b in zip(got, variants["plain"]()))
    return out


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) shrinks the probe:
    ``fields``, ``batch``, ``vocab``, ``dim``."""
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.dedup_probe")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = default_device(args.device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rep = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "nvidia_smi": card()["smi"] if on_card else None,
           "timer": "cuda events" if on_card else "host clock",
           "batch": sizes.get("batch", B), "fields": sizes.get("fields", F),
           "vocab": sizes.get("vocab", VOCAB),
           "row_bytes": sizes.get("dim", EMBED_DIM) * 4}
    for dist in ("uniform", "zipf"):
        rep[dist] = run(dist, args.iters, rng, device=device, generator=gen, **sizes)
    rep["dedup_chain_over_plain"] = {
        dist: rep[dist]["dedup_chain"]["ms"] / rep[dist]["plain"]["ms"]
        for dist in ("uniform", "zipf")}
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()
