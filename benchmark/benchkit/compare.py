"""The comparison that decides a training cell's ``correct``.

The program and the reference each give, for the same first steps from the
same start: each step's loss, each leaf's norm of the first gradient, and
each leaf's norm of its change over the steps.  Three numbers come of them:

- ``loss_gap``: |program − reference| / |reference| of the first step's
  loss, where both sides start from the same weights (the later steps'
  losses follow trajectories that part by rounding, and swing from seed to
  seed: ``loss_gaps`` gives each step's);
- ``grad_gap``: over the leaves, the largest gap between the program's norm
  of the first gradient and the reference's, over the reference's norm of
  that leaf (floored at a thousandth of the median leaf's, since some
  gradients are all but zero);
- ``change_gap``: the same for the norm of the change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (the
  others move by round-off alone under Adam).

Each leaf is measured against its own norm, so a leaf that one side leaves
unmoved, or moves double, reads about 1 whatever its size.

A cell's workload file gives the limit of each number it compares; a
number without one is read and shown but decides nothing (PERF.md says
why each is left out).  A compared number passes when it is at most its
limit; one that is not a finite number fails.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median's


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: |program − reference| / the reference's norm of the leaf,
    floored at ``STILL`` × the median leaf's}."""
    floor = STILL * statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def worst_leaf(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    worst, at = 0.0, ""
    for k, gap in leaf_gaps(prog, ref, leaves).items():
        if not math.isfinite(gap) or gap > worst:
            worst, at = gap, k
            if not math.isfinite(gap):
                break
    return worst, at


def loss_gaps(prog: dict, ref: dict) -> list:
    """|program − reference| / |reference| of each step's loss."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"], strict=True)]


def gaps(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} for the readings of both sides."""
    if set(prog["grad_norm"]) != set(ref["grad_norm"]):
        raise ValueError("the program's and the reference's leaves differ")
    losses = loss_gaps(prog, ref)
    g_med = statistics.median(ref["grad_norm"].values())
    moving = [k for k, g in ref["grad_norm"].items() if g >= STILL * g_med]
    return {
        "loss_gap": (losses[0], "step 1"),
        "grad_gap": worst_leaf(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"]),
        "change_gap": worst_leaf(prog["change_norm"], ref["change_norm"], moving),
    }


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {'value', 'limit', 'at'}}) for ``gaps``'s result,
    over the numbers that ``limits`` holds."""
    if not limits or set(limits) - set(found):
        raise ValueError(f"limits {sorted(limits)} name no number of {sorted(found)}")
    checks = {k: {"value": found[k][0], "limit": float(lim), "at": found[k][1]}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
