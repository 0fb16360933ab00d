"""How the flash-attention kernels are held against their plain versions,
shared by chip_smoke.py and tests/test_torch_cuda.py (imports no JAX).

The kernels and the plain versions (recsys_tpu_torch/kernels/attention.py)
both compute in exact f32 and differ only in the order of their sums: the
kernel's online softmax over 64-key tiles against one softmax over every
key.  Against the same formulas in float64 the plain version is within
1e-5 absolute plus 1e-5 relative (tests/test_torch_attention.py): a
gradient summed over hundreds of rows can be large, and elements near zero
after cancellation have large relative errors.  The limits below are at
least five times that distance.

Each limit must also fail a wrong result.  The wrong results are the plain
version with one deliberate fault in its (query, key) mask, the faults a
tile kernel can make: the last key tile left out, and (with causal masking)
the diagonal tile left unmasked.  The backward's wrong results use the
right residuals (out, lse), as a faulty backward kernel would.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import attention as attn

TILE = 64  # the kernels' tile of keys and queries
OUT_TOL = dict(rtol=1e-4, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=5e-5)
TOLS = {"out": OUT_TOL, "lse": LSE_TOL, "dq": GRAD_TOL, "dk": GRAD_TOL, "dv": GRAD_TOL}
MASKS = ("none", "random", "front-padded")


def inputs(rng, b, h, s, d, mask_kind, device):
    """q, k, v, do (B, H, S, D) f32 from ``rng`` and a (B, S) int32 mask or
    None: 'random' keeps each key with probability 3/4; 'front-padded' is
    SASRec's layout, histories of 1..S items padded in front, the last one
    empty when B > 1 (so causal rows before a history's start, and every row of the
    empty one, have no key to attend)."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32))
                   .to(device) for _ in range(4))
    if mask_kind == "none":
        mask = None
    elif mask_kind == "random":
        mask = rng.random((b, s)) > 0.25
    else:
        lens = rng.integers(1, s + 1, b)
        lens[-1] = 0 if b > 1 else lens[-1]
        mask = np.arange(s)[None, :] >= s - lens[:, None]
    if mask is not None:
        mask = torch.from_numpy(mask.astype(np.int32)).to(device)
    return q, k, v, do, mask


def wrong_keeps(mask, s, causal, device) -> dict:
    """{fault: keep mask} of the deliberately wrong versions."""
    idx = torch.arange(s, device=device)
    keep = attn.keep_mask(mask, s, s, causal, device)
    keep = torch.ones((s, s), dtype=torch.bool, device=device) if keep is None else keep
    out = {"last key tile left out": keep & (idx[None, :] < (s - 1) // TILE * TILE)}
    if causal:
        key = (mask != 0)[:, None, None, :] if mask is not None else True
        same_tile = idx[:, None] // TILE == idx[None, :] // TILE
        out["diagonal tile unmasked"] = key & ((idx[:, None] >= idx[None, :]) | same_tile)
    return out


def _close(got, want, tol) -> bool:
    return got.shape == want.shape and bool(
        (torch.isclose(got.double(), want.double(), **tol) & torch.isfinite(got)).all())


def check(q, k, v, do, mask, causal, fwd, bwd) -> dict:
    """The kernels ``fwd`` and ``bwd`` (the dispatch wrappers) against the
    plain versions on one case.  The backward kernel gets the plain
    forward's residuals, so it is held on its own.  Returns per tensor the
    largest abs error, whether it is within its limit, and the largest error
    of each wrong result with whether every limit rejected it."""
    s = q.shape[2]
    keep = attn.keep_mask(mask, s, s, causal, q.device)
    out, lse = attn.masked_fwd(q, k, v, keep)
    want = {"out": out, "lse": lse,
            **dict(zip(("dq", "dk", "dv"), attn.masked_bwd(q, k, v, keep, out, lse, do)))}
    got = dict(zip(("out", "lse"), fwd(q, k, v, mask, causal)))
    got.update(zip(("dq", "dk", "dv"), bwd(q, k, v, mask, out, lse, do, causal)))
    res = {"errors": {n: float((got[n].double() - want[n].double()).abs().max()) for n in want},
           "within": {n: _close(got[n], want[n], TOLS[n]) for n in want}, "wrong": {}}
    for fault, wkeep in wrong_keeps(mask, s, causal, q.device).items():
        wout, wlse = attn.masked_fwd(q, k, v, wkeep)
        wrong = {"out": wout, "lse": wlse, **dict(zip(
            ("dq", "dk", "dv"), attn.masked_bwd(q, k, v, wkeep, out, lse, do)))}
        res["wrong"][fault] = {
            "errors": {n: float((wrong[n].double() - want[n].double()).abs().max())
                       for n in want},
            "rejected": all(not _close(wrong[n], want[n], TOLS[n]) for n in want)}
    res["ok"] = all(res["within"].values()) and all(
        w["rejected"] for w in res["wrong"].values())
    return res
