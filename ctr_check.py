"""How the FM bi-interaction kernel is held against its plain version,
shared by chip_smoke.py and tests/test_torch_cuda.py (imports no JAX).

Both compute out[b, d] = 0.5·((Σ_f x)² − Σ_f x²) with f32 sums from the same
f32 values (a bf16 input converts exactly), in another order.  The formula
cancels: where one large field dominates, the output is a small difference
of two large squares.  So the limit is scaled per element by the magnitude
of the terms, (Σ_f |x_fd|)², not by the output: an f32 sum of F terms in
any order is within F·2⁻²⁴ of that scale, about 4e-6 at F = 70, and
rounding errors of random signs stay far below it.

Each limit must also fail a wrong result: the sums without the last field,
and the output without the factor 0.5.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from recsys_tpu_torch.kernels import interactions as int_ref

LIMIT = 1e-5  # of (Σ_f |x_fd|)², per element
FIELDS = (1, 2, 26, 39, 70)
WIDTHS = (1, 8, 16, 32, 36)
BATCHES = (0, 1, 513, 4096)
KINDS = ("normal", "cancelling")


def cases():
    """(B, F, D, dtype, kind) of the check: every B, F and D in f32 and
    bf16 with normal inputs, and the cancelling inputs at the path's
    shapes."""
    for b, f, d, dtype in itertools.product(BATCHES, FIELDS, WIDTHS,
                                            (torch.float32, torch.bfloat16)):
        yield b, f, d, dtype, "normal"
    for f, dtype in itertools.product((26, 39), (torch.float32, torch.bfloat16)):
        yield 4096, f, 16, dtype, "cancelling"


def inputs(rng, b, f, d, dtype, kind, device) -> torch.Tensor:
    """(B, F, D) from ``rng``: standard normal, or 'cancelling': fields of
    order 1e-3 with one field of order 1e3 in each (example, column), so the
    output is a difference of two squares about 1e6 apart from it."""
    x = rng.standard_normal((b, f, d)).astype(np.float32)
    if kind == "cancelling":
        x *= np.float32(1e-3)
        big = rng.integers(0, f, (b, d))
        np.put_along_axis(x, big[:, None, :],
                          rng.standard_normal((b, 1, d)).astype(np.float32) * 1e3, axis=1)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def excess(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Largest |got − want| over its limit, LIMIT·(Σ_f |x_fd|)²; at most 1
    passes.  0 for an empty batch."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    diff = (got.double() - want.double()).abs()
    scale = LIMIT * x.double().abs().sum(dim=1) ** 2
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / scale)
    return float(ratio.max()) if bool(torch.isfinite(got).all()) else float("inf")


def wrong_results(x: torch.Tensor) -> dict:
    """{fault: output} of the deliberately wrong versions."""
    right = int_ref.fm_pairwise_vector(x)
    return {"sum without the last field": int_ref.fm_pairwise_vector(x[:, :-1]),
            "output without the 0.5": 2.0 * right}


def check(kernel, x: torch.Tensor) -> dict:
    """``kernel(x)`` against the plain version: its excess over the limit
    and, where the input can tell (B ≥ 1, F ≥ 2), the least excess of the
    wrong results, which must be above 1."""
    got = kernel(x)
    want = int_ref.fm_pairwise_vector(x)
    out = {"excess": excess(got, want, x),
           "max_abs_err": float((got.double() - want.double()).abs().max())
           if got.numel() else 0.0}
    if x.shape[0] >= 1 and x.shape[1] >= 2:
        out["wrong_least_excess"] = min(excess(w, want, x) for w in wrong_results(x).values())
    return out
