"""The program's spans in a training cell: the layers of the host's
``Trainer.train_step`` call, read on the card.

    python3 benchmark/span_windows.py --workload <cell> --seed <n> [--seconds 10]

Run it from the root of a checkout, on a machine with the card the cell
asks for.  It sets the cell up as ``kinds/train.py`` does (the pool from
the seed, the program with the benchmark's weights, the checked and
warm-up steps; no reference), then runs three windows on the pool's
batches in order:

1. the timed window (``kinds/train.py``'s own, spans off) for
   ``--seconds``: the mean host call it reads as ``host.train_step_call_ms``;
2. A: as many steps as the kind's traced sub-window, with the spans
   recorded (``recsys_tpu_torch.train.profiling``) and no profiler: each
   span's self time a step (``host.prep_ms``, ``host.copy_ms``,
   ``host.gather_ms``, ``host.forward_ms``, ``host.backward_ms``,
   ``host.dense_adam_ms``, ``host.embed_update_ms``; ``train_step``'s own
   beside them), the blocking copies' share of the bytes copied
   (``host.copy_blocking_pct``), the direct children's share of the root's
   time, and the recorder's cost: A's mean ``train_step`` span against the
   timed window's mean call;
3. B: as many steps again with the spans recorded under the kind's
   device-only profiling (``devtrace.profile_steps``): the device's idle
   time inside the window put down to the innermost span over each part
   (``idle_by_span``, the top 10, ``between steps`` under none), and its
   sum against the window's idle time.

It prints one JSON object on standard output and the windows on standard
error.  Exit codes: 0 printed; 3 no card; 1 anything else.

It reads these names of ``kinds/train.py``, which its CPU test
(``tests/test_bench_span_windows.py``) pins, so a change to the kind
breaks the test before it breaks this script: ``CHECK_STEPS`` and
``WARMUP_STEPS`` (the steps before the window), ``TRACED_SECONDS`` (the
traced sub-window's length) and ``_window(prog, pool, start, seconds,
device)`` (the timed window; returns steps, host seconds, each step's ms
and each call's ms).  The spans' arithmetic is ``benchkit/spans.py``.
"""
from __future__ import annotations

import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

ROOT = "train_step"
LAYERS = {  # metric: the span whose self time a step it is
    "host.prep_ms": "train_step.prep", "host.copy_ms": "train_step.copy",
    "host.gather_ms": "embedding.gather", "host.forward_ms": "train_step.forward",
    "host.backward_ms": "train_step.backward", "host.dense_adam_ms": "train_step.dense_adam",
    "host.embed_update_ms": "train_step.embed_update"}
TOP = 10


def read_spans(records) -> dict:
    """Window A's numbers from its spans: each layer's self ms a step,
    ``train_step``'s own, its mean ms, the children's share of it and the
    blocking copies' share of the bytes."""
    from benchkit import spans

    roots = [r for r in records if r.name == ROOT and r.parent is None]
    if not roots:
        return {}
    n, root_ns = len(roots), sum(r.duration_ns for r in roots)
    own = spans.self_times(records)
    out = {k: own.get(name, 0) / n * 1e-6 for k, name in LAYERS.items()}
    copies = [r.counts for r in records if r.name == "train_step.copy"]
    blocking = sum(c.get("bytes_blocking", 0) for c in copies)
    total = blocking + sum(c.get("bytes_async", 0) for c in copies)
    if total:
        out["host.copy_blocking_pct"] = blocking / total * 100.0
    out.update({
        "train_step_self_ms": own.get(ROOT, 0) / n * 1e-6,
        "train_step_span_ms": root_ns / n * 1e-6,
        "children_cover_pct": (root_ns - own.get(ROOT, 0)) / root_ns * 100.0,
        "steps": n})
    return out


def measure(cell, seed: int, seconds: float, device, log=sys.stderr) -> dict:
    import numpy as np
    import torch

    from benchkit import devtrace, guard, registry, spans
    from benchkit.seeds import TRAFFIC, sub_seed
    from recsys_tpu_torch.train import profiling

    kind = registry.kind(cell.kind)
    device = torch.device(device)
    fam = registry.family(cell.config["family"])
    dims = fam.dims(cell.config)
    pool = registry.generator(cell.traffic["generator"]).make_pool(
        cell.traffic, dims["rows"], dims["num_dense"], cell.batch, sub_seed(seed, TRAFFIC),
        device)
    prog = fam.Program(cell.config, seed, device)
    at = kind.CHECK_STEPS + kind.WARMUP_STEPS
    for k in range(at):
        prog.step(pool[k % len(pool)])
    guard.check()

    steps, elapsed, step_ms, call_ms = kind._window(prog, pool, at, seconds, device)
    at += steps
    step_s = sum(step_ms) / len(step_ms) * 1e-3
    n = max(10, math.ceil(kind.TRACED_SECONDS / step_s))
    call = float(np.mean(call_ms))
    print(f"timed: {steps} steps in {elapsed:.6f} s, mean call {call:.6f} ms, mean step "
          f"{step_s * 1e3:.6f} ms", file=log)

    with profiling.recording() as records:
        for k in range(n):
            prog.step(pool[(at + k) % len(pool)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    at += n
    out = {"host.train_step_call_ms": call, **read_spans(records)}
    out["recorder_cost_pct"] = (out["train_step_span_ms"] / call - 1.0) * 100.0
    print(f"A: {n} steps; train_step span {out['train_step_span_ms']:.6f} ms against the "
          f"timed call {call:.6f} ms", file=log)

    with profiling.recording() as records:
        tr = devtrace.profile_steps(lambda k: prog.step(pool[(at + k) % len(pool)]), n,
                                    device)
    idle = spans.idle_by_span(records, tr.busy_intervals(), tr.window)
    idle_ns = (tr.window[1] - tr.window[0]) - sum(e - s for s, e in tr.busy_intervals())
    out["idle_by_span"] = [[k, v * 1e-9] for k, v in
                           sorted(idle.items(), key=lambda x: -x[1])[:TOP]]
    out["idle_s"], out["idle_by_span_sum_s"] = idle_ns * 1e-9, sum(idle.values()) * 1e-9
    out["traced_step_ms"] = tr.window_s / n * 1e3
    print(f"B: {n} steps, {out['traced_step_ms']:.6f} ms a step, idle "
          f"{out['idle_s']:.6f} s", file=log)
    guard.check()
    kind_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"workload": cell.name, "seed": seed, "device": kind_name, **out}


def main(argv=None) -> int:
    import argparse
    import json
    import traceback

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from benchkit import registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    t0 = time.time()
    try:
        result = measure(registry.cell(args.workload), args.seed, args.seconds, "cuda")
    except Exception:  # the run's boundary: report and fail, print no result
        traceback.print_exc()
        return 1
    print(f"span windows: {time.time() - t0:.3f} s", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
