"""The benchmark of recsys_tpu_torch: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout, on a machine with the card(s) the
cell asks for.  It sets up the cell (``workloads/<cell>.json``), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines of standard error).

Exit codes: 0 a result was printed; 2 bad arguments; 3 no card, or fewer
than the cell asks for; 4 a forbidden module (JAX or the JAX package) was
loaded; 1 anything else.  Nothing is printed on standard output but the
result.
"""
from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The process's start, on the ``time.time()`` clock (to the kernel's
    clock tick), or now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return time.time()
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


PROCESS_START = process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    import argparse
    import json
    import traceback

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must not be negative")

    import torch

    from benchkit import cell as cell_lib
    from benchkit import guard, registry

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 3
    try:
        result = cell_lib.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                   PROCESS_START)
    except guard.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 4
    except Exception:  # the run's boundary: report and fail, print no result
        traceback.print_exc()
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
