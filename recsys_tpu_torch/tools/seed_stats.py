"""Aggregate multi-seed protocol reports into mean±sd tables (the port's
copy of ``recsys_tpu/tools/seed_stats.py``; numpy only).

``aggregate`` reads per-seed ``protocol ctr`` reports, written by

    python -m recsys_tpu_torch.tools.protocol ctr --seed {0,1,2} \
        --out artifacts/torch/protocol_ctr_fm_s{seed}.json

(or the JAX package's), and gives per-model mean/sd of test AUC and of the
share of the oracle margin across seeds, and whether every deep model beats
FM, counted per seed (each seed is another generator draw, so the
oracle-normalised margin is the comparable quantity).
``aggregate_generic`` does the same for any protocol mode, every quality
metric of the reports.

Run: python -m recsys_tpu_torch.tools.seed_stats REPORT.json ... [--generic]
     [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def aggregate(paths: list[str]) -> dict:
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    out: dict = {"teachers": {}}
    for teacher in sorted({r.get("teacher", "fm") for r in runs}):
        rs = [r for r in runs if r.get("teacher", "fm") == teacher]
        models = sorted({m for r in rs for m in r["models"]})
        table = {}
        for m in models:
            aucs = [r["models"][m]["test_auc"] for r in rs if m in r["models"]]
            pcts = [r["models"][m]["pct_of_oracle"] for r in rs
                    if m in r["models"]]
            table[m] = {
                "seeds": len(aucs),
                "auc_mean": round(float(np.mean(aucs)), 4),
                "auc_sd": round(float(np.std(aucs, ddof=1)), 4)
                if len(aucs) > 1 else None,
                "pct_oracle_mean": round(float(np.mean(pcts)), 1),
                "pct_oracle_sd": round(float(np.std(pcts, ddof=1)), 2)
                if len(pcts) > 1 else None,
            }
        entry: dict = {"models": table,
                       "oracle_aucs": [r["oracle_auc"] for r in rs],
                       "seeds": len(rs)}
        if "fm" in models:
            # per-seed verdict: does every deep model beat FM on this draw?
            # Only seeds whose run actually includes an fm entry contribute
            # (a run produced with --models lacking fm is skipped, not a
            # KeyError), and the count of contributing seeds is recorded.
            per_seed = []
            for r in rs:
                if "fm" not in r["models"]:
                    continue
                fm_auc = r["models"]["fm"]["test_auc"]
                deep = {m: v["test_auc"] for m, v in r["models"].items()
                        if m != "fm"}
                per_seed.append(all(v > fm_auc for v in deep.values()))
            entry["deep_beats_fm_per_seed"] = per_seed
            entry["deep_beats_fm_seeds_counted"] = len(per_seed)
        out["teachers"][teacher] = entry
    return out


_METRIC_HINTS = ("auc", "recall", "hr@", "ndcg")


def _metrics_of(d: dict, prefix: str = "") -> dict:
    """Flatten the numeric quality metrics of one protocol report
    (top-level HR@10/recall@10/... and per-model auc_*/recall@* entries;
    seconds/epoch bookkeeping excluded)."""
    out = {}
    for k, v in d.items():
        lk = k.lower()
        if k == "models" and isinstance(v, dict):
            for m, mv in v.items():
                out.update(_metrics_of(mv, prefix=f"{m}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            if any(h in lk for h in _METRIC_HINTS):
                out[prefix + k] = float(v)
    return out


def aggregate_generic(paths: list[str]) -> dict:
    """Mode-agnostic multi-seed aggregation: groups runs by their 'mode'
    field, reports every quality metric's per-seed values + mean±sd."""
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    out: dict = {"modes": {}}
    for mode in sorted({r.get("mode", "ctr") for r in runs}):
        rs = [r for r in runs if r.get("mode", "ctr") == mode]
        metrics: dict[str, list[float]] = {}
        for r in rs:
            for k, v in _metrics_of(r).items():
                metrics.setdefault(k, []).append(v)
        table = {}
        for k, vals in sorted(metrics.items()):
            table[k] = {
                "values": [round(v, 4) for v in vals],
                "mean": round(float(np.mean(vals)), 4),
                "sd": round(float(np.std(vals, ddof=1)), 4)
                if len(vals) > 1 else None,
            }
        entry: dict = {"seeds": len(rs), "metrics": table}
        out["modes"][mode] = entry
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+", help="protocol_ctr_*.json artifacts")
    p.add_argument("--out", default=None)
    p.add_argument("--generic", action="store_true",
                   help="mode-agnostic aggregation over every quality "
                   "metric of the reports")
    args = p.parse_args(argv)
    if args.generic:
        rep = aggregate_generic(args.paths)
        w = sys.stderr.write
        for mode, entry in rep["modes"].items():
            w(f"\nmode={mode} ({entry['seeds']} seeds)\n")
            w("| metric | mean±sd | per-seed |\n|---|---|---|\n")
            for k, v in entry["metrics"].items():
                sd = f"±{v['sd']:.4f}" if v["sd"] is not None else ""
                w(f"| {k} | {v['mean']:.4f}{sd} | {v['values']} |\n")
        payload = json.dumps(rep)
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload + "\n")
        print(payload)
        return
    rep = aggregate(args.paths)

    w = sys.stderr.write
    for teacher, entry in rep["teachers"].items():
        w(f"\nteacher={teacher} ({entry['seeds']} seeds, oracle AUCs "
          f"{entry['oracle_aucs']})\n")
        w("| model | AUC mean±sd | % of oracle margin |\n|---|---|---|\n")
        for m, v in entry["models"].items():
            sd = f"±{v['auc_sd']:.4f}" if v["auc_sd"] is not None else ""
            psd = (f"±{v['pct_oracle_sd']:.2f}"
                   if v["pct_oracle_sd"] is not None else "")
            w(f"| {m} | {v['auc_mean']:.4f}{sd} | "
              f"{v['pct_oracle_mean']:.1f}{psd} |\n")
        if "deep_beats_fm_per_seed" in entry:
            w(f"deep beats FM per seed: {entry['deep_beats_fm_per_seed']}\n")

    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        with open(args.out) as f:
            if not f.read().rstrip().endswith(payload.rstrip()):
                raise RuntimeError(f"artifact write failed at {args.out!r}")
    print(payload)


if __name__ == "__main__":
    main()
