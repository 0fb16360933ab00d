"""How two fused-MLP backward passes are held against each other: the
comparison that ``chip_smoke.py`` and the port's tests share (it imports
torch only).

Two checks, since no single one both passes every correct kernel and fails
a wrong one:

1. Exact (:func:`exact_case`).  Small integer inputs, weights, biases and
   cotangents keep every sum of the forward and backward an integer far
   below 2^24, so f32 adds it up exactly in any order, and every rounding
   to bf16 rounds the same value.  A correct kernel then equals the plain
   version bit for bit, dx, dW and db, at any width and batch: a dW scaled
   by 0.9, or one 32-row step of its batch sum left out, fails.
2. Random weights.  dx is held to the MLP's tolerance as a plain tensor.
   A dW or db element is a sum over the batch.  In exact f32 each element
   holds to 1e-4 of the sum of the magnitudes of its terms
   (:func:`term_scales`), which it can lose wholly when the terms cancel.
   In bf16 no element-wise limit is sound: one hidden value or cotangent
   rounded to the neighbouring bf16 moves the next layer's sums, which
   rounds more values differently and carries some of them across the
   relu's kink, so a few elements move by a large share of their terms,
   the plain version's too against the same chain summed in float64
   (:func:`f64_chain`, :func:`q999_over_terms`).  Each bf16 dW and db is held instead by its
   relative norm error (:func:`norm_err`), which these few elements barely
   move: at most ``BF16_NORM_RTOL``, where a dW scaled by 0.9 is 0.1 off
   (``chip_smoke.py`` prints the readings; ``PERF.md`` records them).

Rows at a relu kink in exact arithmetic are left out of check 2 first
(:func:`kink_free_rows`).
"""
from __future__ import annotations

import numpy as np

F32_TERM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_NORM_RTOL = 4e-2
EXACT_NNZ = 16       # nonzero weights per output column in the exact case
EXACT_LIMIT = 2.0 ** 24


def exact_case(rng: np.random.Generator, b: int, dims):
    """(x (b, D0), g (b, Dk), [W_i], [b_i (1, D_{i+1})]) as float32 numpy
    arrays of small integers: x and g in {0, 1} and {-1, 0, 1}, biases in
    {-1, 0, 1}, and about EXACT_NNZ weights of ±1 per output column, so
    that a hidden unit is active for about half the rows."""
    ws = [((rng.integers(0, 2, (a, c)) * 2 - 1) * (rng.random((a, c)) < min(1.0, EXACT_NNZ / a)))
          .astype(np.float32) for a, c in zip(dims, dims[1:])]
    bs = [rng.integers(-1, 2, (1, c)).astype(np.float32) for c in dims[1:]]
    x = rng.integers(0, 2, (b, dims[0])).astype(np.float32)
    g = rng.integers(-1, 2, (b, dims[-1])).astype(np.float32)
    return x, g, ws, bs


def largest_term_sum(x, g, ws, bs) -> float:
    """The largest sum of term magnitudes of any output of any product in
    the chain (forward, backward, dW, db), in float64 with the bf16
    roundings: below EXACT_LIMIT, f32 adds every one of them exactly."""
    import torch

    r = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    W = [w.double() for w in ws]
    B = [v.double().reshape(-1) for v in bs]
    n, hs, top = len(W), [r(x)], 0.0
    for i in range(n):
        top = max(top, float((hs[-1].abs() @ W[i].abs() + B[i].abs()).max()))
        if i < n - 1:
            hs.append(r(torch.relu(hs[-1] @ W[i] + B[i])))
    dh = r(g)
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            dh = r(dh * (hs[i + 1] > 0))
        top = max(top, float((hs[i].abs().t() @ dh.abs()).max()),
                  float(dh.abs().sum(0).max()), float((dh.abs() @ W[i].abs().t()).max()))
        dh = r(dh @ W[i].t())
    return top


def f64_chain(x, g, ws, bs, mm_bf16: bool = True):
    """(dx, [dW_i], [db_i]) of the plain ``mlp_backward``'s rounding chain
    with every sum in float64."""
    import torch

    mm = torch.bfloat16 if mm_bf16 else torch.float32
    r = lambda t: t.to(mm).double()  # noqa: E731
    n = len(ws)
    W = [r(w) for w in ws]
    hs = [r(x)]
    for i in range(n - 1):
        hs.append(r(torch.relu(hs[-1] @ W[i] + bs[i].double().reshape(-1))))
    dh = r(g)
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            dh = r(dh * (hs[i + 1] > 0))
        dws[i] = hs[i].t() @ dh
        dbs[i] = dh.sum(0).reshape(bs[i].shape)
        dh = r(dh @ W[i].t())
    return dh, dws, dbs


def term_scales(x, g, ws, bs):
    """([S_W_i], [S_b_i]): for each dW_i and db_i of the plain
    ``mlp_backward``, the sum of the magnitudes of the terms it adds up,
    ``|h_i|ᵀ·|dz_i|`` and ``Σ|dz_i|``, in f32 without rounding."""
    import torch

    n = len(ws)
    hs = [x.float()]
    for i in range(n - 1):
        hs.append(torch.relu(hs[-1] @ ws[i].float() + bs[i].reshape(-1).float()))
    dz = g.float()
    sw, sb = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            dz = dz * (hs[i + 1] > 0)
        sw[i] = hs[i].abs().t() @ dz.abs()
        sb[i] = dz.abs().sum(0).reshape(bs[i].shape)
        dz = dz @ ws[i].float().t()
    return sw, sb


def kink_free_rows(x, ws, bs, rel: float = 1e-6):
    """(B,) bool: the rows whose every hidden pre-activation lies more than
    ``rel`` of the magnitude of its terms away from zero.  The relu's
    derivative jumps at zero, so at a row outside this set two correct
    passes that sum in different orders may take opposite sides of the
    kink, and their gradients for that row then differ by O(1)."""
    import torch

    h, keep = x.float(), torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = h @ w.float() + b.reshape(-1).float()
        terms = h.abs() @ w.float().abs() + b.reshape(-1).float().abs()
        keep &= ((z.abs() > rel * terms) | (terms == 0)).all(1)
        h = torch.relu(z)
    return keep


def f32_outside(got, want, scale) -> float:
    """Share of the elements of an exact-f32 dW or db outside
    ``F32_TERM_TOL`` of their terms."""
    tol = F32_TERM_TOL
    return float(((got - want).abs() > tol["rtol"] * scale + tol["atol"]).double().mean())


def q999_over_terms(got, want, scale) -> float:
    """The 99.9th percentile over the elements of ``|got - want|`` as a
    share of the magnitudes of their terms."""
    import torch

    r = ((got.double() - want.double()).abs() / (scale.double() + 1e-30)).reshape(-1)
    return float(torch.kthvalue(r.cpu(), max(1, int(round(0.999 * r.numel())))).values)


def norm_err(got, want) -> float:
    """``‖got - want‖ / ‖want‖`` in float64 (``‖got‖`` when ``want`` is
    zero)."""
    diff, den = (got.double() - want.double()).norm(), want.double().norm()
    return float(diff / den) if den > 0 else float(diff)
