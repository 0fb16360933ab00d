"""Readings that the correctness limits of a cell are set from (not part of
a benchmark run).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out calibrate_<cell>.json]

For each of ``--seeds``: the program's first steps at the cell's own size,
from the seed's start and on its traffic, against the plain reference, as
a run checks them (``loss_gap``, ``grad_gap``, ``change_gap``).  For each
of ``--control-seeds``: the same numbers for the control (the reference
computed in float8, put in the program's place) and for the planted fault
of half the batch left out (the reference's loss over the first half,
in the program's place).  A step that leaves the state unchanged reads
``change_gap`` 1 by the measure and needs no run.  Prints one JSON object
with every reading and, per number, the program's largest and the
control's and the fault's smallest.
"""
from __future__ import annotations

import gc
import json
import statistics
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def readings(cell, seeds, control_seeds, device) -> dict:
    import torch

    from benchkit import compare, registry
    from benchkit.seeds import TRAFFIC, sub_seed

    fam = registry.family(cell.config["family"])
    dims = fam.dims(cell.config)
    n_check = registry.kind(cell.kind).CHECK_STEPS
    gen = registry.generator(cell.traffic["generator"])

    def free():
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    def first(seed):
        return gen.make_pool(cell.traffic, dims["rows"], dims["num_dense"], cell.batch,
                             sub_seed(seed, TRAFFIC), device)[:n_check]

    def read(got, ref):
        """The numbers, each step's loss gap, and each leaf's gaps."""
        moving = [k for k, g in ref["grad_norm"].items()
                  if g >= compare.STILL * statistics.median(ref["grad_norm"].values())]
        return dict(compare.gaps(got, ref), loss_gaps=compare.loss_gaps(got, ref),
                    grad_leaves=compare.leaf_gaps(got["grad_norm"], ref["grad_norm"],
                                                  ref["grad_norm"]),
                    change_leaves=compare.leaf_gaps(got["change_norm"], ref["change_norm"],
                                                    moving),
                    ref_grad=ref["grad_norm"], ref_change=ref["change_norm"])

    out = {"program": {}, "control": {}, "half_batch": {}}
    for seed in seeds:
        batches = first(seed)
        prog = fam.Program(cell.config, seed, device)
        got = prog.check_steps(batches)
        del prog
        free()
        ref = fam.reference_readings(cell.config, seed, batches, device)
        out["program"][seed] = read(got, ref)
        print(seed, "program", {k: out["program"][seed][k] for k in compare.NAMES},
              file=sys.stderr, flush=True)
    for seed in control_seeds:
        batches = first(seed)
        ref = fam.reference_readings(cell.config, seed, batches, device)
        for kind, kw in (("control", {"quant": "fp8"}), ("half_batch", {"half_batch": True})):
            got = fam.reference_readings(cell.config, seed, batches, device, **kw)
            out[kind][seed] = read(got, ref)
            print(seed, kind, {k: out[kind][seed][k] for k in compare.NAMES},
                  file=sys.stderr, flush=True)
        free()
    summary = {}
    for k in compare.NAMES:
        summary[k] = {"program_max": max((g[k][0] for g in out["program"].values()),
                                         default=None)}
        for kind in ("control", "half_batch"):
            summary[k][f"{kind}_min"] = min((g[k][0] for g in out[kind].values()),
                                            default=None)
    out["summary"] = summary
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from benchkit import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    res = readings(registry.cell(args.workload), seeds, control, "cuda")
    res["workload"] = args.workload
    if torch.cuda.is_available():
        res["card"] = torch.cuda.get_device_name()
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
