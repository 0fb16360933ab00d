"""The fused update's chunk length ``ch``, swept: what each value costs a
DLRM step with ``fused_adam`` on the card, in the native host prep, the
copy of its arrays to the card, the 26 cotangent gathers and #4.

Two shapes, each a DLRM of the path that preps (26 tables, D = 16, bf16):

* ``files``: the file-fed fit, 26 tables of 2^20 rows, 4096 ids a table
  from Zipf(1.1) ranks through a random permutation of the rows, the
  CLI's default towers;
* ``bench``: ``bench.py``'s step, 26 tables of 100,000 rows, 16384
  uniform ids a table, its towers and 4 microbatches.

For each ``ch`` (in the order given, then reversed: two turns on one card),
it reads ``prep_ms`` (host, median of 5), the arrays' ``bytes`` and
``copy_ms`` (host clock around the pinned ``non_blocking`` copies and a
synchronise, median of 5), ``gather_ms`` (the 26 ``index_select``s of the
(B·F, D) cotangent and their bf16 rounding, CUDA events), ``adam_ms`` (#4
alone, one launch over the 26 tables, CUDA events) against its bytes bound
``adam_bound_ms`` (p, m and v read and written, the batch's cotangent rows,
ids and chunk pointers read once, at 3.35 TB/s), and ``step_ms`` (one
``Trainer.train_step`` from the prepped batch, host clock to a
synchronise, median of 7).  ``prep_ch`` is the chunk length the
``Trainer`` preps at (``streaming_embed.PREP_CH``).

Run: python -m recsys_tpu_torch.tools.prep_sweep [--ch 1,2,4,8,16,32,64,256]
                                                 [--device cpu] [--out FILE]
One JSON object on stdout.  On the CPU the times are the host clock's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.tools.dedup_probe import zipf_ids
from recsys_tpu_torch.tools.roofline import SPECS, card, timer
from recsys_tpu_torch.train import streaming_embed
from recsys_tpu_torch.train.loop import Trainer

SHAPES = {
    "files": dict(tables=26, rows=1 << 20, dim=16, batch=4096, ids="zipf", towers={}),
    "bench": dict(tables=26, rows=100_000, dim=16, batch=16384, ids="uniform",
                  towers=dict(bottom_units=(512, 256, 16), top_units=(1024, 1024, 512, 256),
                              dense_microbatch=4)),
}
LR = 1e-3
ITERS = 20  # CUDA-event iterations of each gather and #4 reading
HBM_BYTES_PER_S = SPECS["NVIDIA H100 80GB HBM3"]["hbm_bw"]


def _median_ms(fn, n: int, sync) -> float:
    out = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def sweep_shape(shape: dict, chs: list, rng, device) -> dict:
    """One shape's trainer and batch, and each ``ch``'s readings in two
    turns."""
    f, rows, d, b = shape["tables"], shape["rows"], shape["dim"], shape["batch"]
    schema = FeatureSchema(dense=[DenseFeature(f"I{i}") for i in range(13)],
                           sparse=[SparseFeature(f"C{i}", rows, d) for i in range(f)])
    torch.manual_seed(0)
    tr = Trainer(DLRM(schema, compute_dtype=torch.bfloat16, sparse_embed_grads=True,
                      device=device, **shape["towers"]),
                 learning_rate=LR, embedding_optimizer="fused_adam", device=device)
    if shape["ids"] == "zipf":
        sparse = np.stack([zipf_ids(rng, b, rows) for _ in range(f)], 1)
    else:
        sparse = rng.integers(0, rows, (b, f)).astype(np.int32)
    batch = {"dense": rng.random((b, 13)).astype(np.float32), "sparse": sparse,
             "label": rng.integers(0, 2, b).astype(np.float32)}
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ms = timer(device)
    tables, plan = tr.tables(), tr.plan
    gen = torch.Generator(device=device).manual_seed(1)
    cot_all = torch.randn(b * f, d, generator=gen, device=device)
    blocks = [min(streaming_embed.DEFAULT_BLOCK, t.shape[0]) for t in tables.values()]
    table_bytes = 6 * sum(t.numel() * t.element_size() for t in tables.values())
    out = {"shape": {k: v for k, v in shape.items() if k != "towers"},
           "touched_blocks_per_table": float(np.mean(
               [len(np.unique(sparse[:, j] // blocks[j])) for j in range(f)])),
           "prep_ch": streaming_embed.PREP_CH,
           "turns": []}
    for turn in (list(chs), list(reversed(chs))):
        readings = {}
        for ch in turn:
            prep = streaming_embed.make_host_prep(plan, ch=ch, pin=on_card)
            aux = prep(sparse)
            r = {"prep_ms": _median_ms(lambda: prep(sparse), 5, lambda: None),
                 "bytes": int(sum(v.numel() * 4 if isinstance(v, torch.Tensor) else v.nbytes
                                  for v in aux.values())),
                 "copy_ms": _median_ms(lambda: tr._to_device(aux), 5, sync)}
            db = tr._to_device(aux)
            srcs = [db[f"embaux{g}_src"] for g in range(len(plan.table_names))]
            r["gather_ms"] = ms(lambda: [cot_all.index_select(0, s).bfloat16() for s in srcs],
                                ITERS, 2)
            cots = [cot_all.index_select(0, s).bfloat16() for s in srcs]
            names = plan.table_names
            args = ([tables[n] for n in names], [tr.emb_state[n]["m"] for n in names],
                    [tr.emb_state[n]["v"] for n in names], cots,
                    [db[f"embaux{g}_ids"] for g in range(len(names))],
                    [db[f"embaux{g}_ptr"] for g in range(len(names))])
            r["adam_ms"] = ms(lambda: dispatch.fused_embedding_adam_pass(
                *args, tr.step + 1, blocks=blocks, lr=LR), ITERS, 2)
            nbytes = table_bytes + b * f * (d * 2 + 4) + sum(p.numel() * 4 for p in args[5])
            r["adam_bytes"] = nbytes
            r["adam_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            prepped = dict(batch, **aux)
            tr.train_step(prepped)
            r["step_ms"] = _median_ms(lambda: tr.train_step(prepped), 7, sync)
            readings[str(ch)] = r
            sys.stderr.write(f"ch {ch:4d}: prep {r['prep_ms']:.3f} ms, {r['bytes'] / 1e6:.2f} MB "
                             f"copied in {r['copy_ms']:.3f} ms, gathers {r['gather_ms']:.4f} ms, "
                             f"#4 {r['adam_ms']:.4f} ms (bound {r['adam_bound_ms']:.4f}), "
                             f"step {r['step_ms']:.2f} ms\n")
        out["turns"].append(readings)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.prep_sweep")
    p.add_argument("--ch", default="1,2,4,8,16,32,64,256", help="comma-separated chunk lengths")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = default_device(args.device)
    on_card = device.type == "cuda"
    chs = [int(c) for c in args.ch.split(",")]
    rep = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "nvidia_smi": card()["smi"] if on_card else None,
           "timer": "cuda events" if on_card else "host clock", "ch": chs}
    rng = np.random.default_rng(args.seed)
    for name, shape in SHAPES.items():
        sys.stderr.write(f"[{name}]\n")
        rep[name] = sweep_shape(shape, chs, rng, device)
        if on_card:
            torch.cuda.empty_cache()
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()
