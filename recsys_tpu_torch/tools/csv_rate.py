"""The rate and peak memory of the two Criteo readers on the host: the
label-encode path (``data.criteo.create_criteo_dataset``, Python's ``csv``
module and a typing pass over every field) and the C++ parser
(``data.native.parse_criteo``, which ``data.streaming.CriteoStream`` reads
through, here in one call over the whole file).

A Criteo CSV with a header is written from ``--seed``: 13 integer columns
and 26 hex-token columns, 4-8% of the fields empty.  Each reader then runs
in a process of its own, which reports its rows a second and its peak
resident memory (``ru_maxrss``) beside its resident memory just before the
read (``VmRSS``, Linux).

Run: python -m recsys_tpu_torch.tools.csv_rate --rows 1000000 [--seed 0]
     [--dir DIR] [--out FILE.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

READ = r"""
import json, resource, sys, time
from recsys_tpu_torch.data import criteo, native
path, reader = sys.argv[1], sys.argv[2]
with open("/proc/self/status") as f:
    before = next(int(l.split()[1]) for l in f if l.startswith("VmRSS:"))
t0 = time.perf_counter()
if reader == "label_encode":
    _, train, test = criteo.create_criteo_dataset(path)
    rows = len(train["label"]) + len(test["label"])
else:
    rows = len(native.parse_criteo(path, sep=",", skip_header=True)[0])
s = time.perf_counter() - t0
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"reader": reader, "rows": rows, "seconds": s, "rows_per_s": rows / s,
                  "rss_before_read_kib": before, "peak_rss_kib": peak}))
"""


def write_csv(path: str, rows: int, seed: int) -> int:
    """A Criteo CSV with a header, in blocks of 100,000 rows; its bytes."""
    rng = np.random.default_rng(seed)
    vocab = np.geomspace(8, 1_000_000, 26).astype(np.int64)
    header = ["label", *(f"I{i}" for i in range(1, 14)), *(f"C{i}" for i in range(1, 27))]
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for start in range(0, rows, 100_000):
            n = min(100_000, rows - start)
            cols = [rng.integers(0, 2, n).astype(str)]
            for _ in range(13):
                col = rng.integers(0, 1000, n).astype(str).astype(object)
                col[rng.random(n) < 0.08] = ""
                cols.append(col)
            for j in range(26):
                ids = (rng.zipf(1.2, n) - 1) % vocab[j] + j * 1_000_003
                col = np.char.mod("%08x", ids).astype(object)
                col[rng.random(n) < 0.04] = ""
                cols.append(col)
            f.write("\n".join(",".join(r) for r in zip(*cols)) + "\n")
    return os.path.getsize(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dir", default=None, help="where the CSV is written (a temporary "
                        "directory by default, removed after)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        path = os.path.join(tmp, "criteo.csv")
        report = {"rows": args.rows, "seed": args.seed, "bytes": write_csv(path, args.rows,
                                                                             args.seed)}
        for reader in ("native", "label_encode"):
            out = subprocess.run([sys.executable, "-c", READ, path, reader], cwd=root,
                                 check=True, capture_output=True, text=True).stdout
            report[reader] = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
