"""No module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``recsys_tpu`` may be loaded by a run; ``recsys_tpu_torch`` may."""
import os
import subprocess
import sys

from benchkit import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_compare_whole():
    mods = ["recsys_tpu_torch", "recsys_tpu_torch.train.loop", "jaxtyping", "flaxen",
            "numpy"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["jax.numpy", "recsys_tpu.core", "flax"]) == [
        "flax", "jax", "recsys_tpu"]


def test_a_run_loads_no_forbidden_module():
    """A whole small run on the CPU, in a fresh process, loads none."""
    code = f"""
import sys, time
sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]
from benchkit import cell, guard, registry
c = registry.cell("kaggle-train-zipf")
c.config = dict(c.config, table_rows=[40, 7, 300, 5] * 6 + [9, 11])
c.traffic = dict(c.traffic, pool_batches=5)
c.spec = dict(c.spec, batch=64)
cell.run_cell(c, 3, 0.2, True, "cpu", time.time())
print("forbidden", guard.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(BENCH))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden []"


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    """Here, with no card, the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "kaggle-train-zipf", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(BENCH))
    assert out.returncode != 0
    assert out.stdout == ""
