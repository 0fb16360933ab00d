"""How the flash-attention kernels are held against their plain versions,
shared by chip_smoke.py and tests/test_torch_cuda.py (imports no JAX).

The plain versions (recsys_tpu_torch/kernels/attention.py) compute in
exact f32.  The kernels compute every product in split TF32 on the tensor
cores (three TF32 products with f32 accumulation, accurate to about 2^-22
of each product, kernels/csrc/flash_tiles.cuh), with the online softmax
over key tiles against one softmax over every key.  Against the same
formulas in float64 the plain version is within 1e-5 absolute plus 1e-5
relative (tests/test_torch_attention.py): a gradient summed over hundreds
of rows can be large, and elements near zero after cancellation have large
relative errors.  The limits below are at least five times that distance.

Each limit must also fail a wrong result.  Two wrong results are the plain
version with one deliberate fault in its (query, key) mask, the faults a
tile kernel can make: the last key tile left out, and (with causal masking)
the diagonal tile left unmasked.  The third is the plain version on q, k,
v and dO rounded to TF32, what a kernel that drops the split's small terms
computes: single-pass TF32 products.  The backward's wrong results use the
right residuals (out, lse), as a faulty backward kernel would.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import attention as attn

TILE = 32  # the long-sequence kernels' key tile (and the dk/dv query tile) at D <= 32
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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low
    mantissa bits dropped, to nearest with ties away from zero (adding half
    a TF32 ulp to the magnitude bits carries into the exponent where it
    must).  Integer bit operations, so it runs alike on CPU and CUDA."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def float64_reference(q, k, v, do, mask, causal) -> dict:
    """out, lse, dq, dk and dv by the flash formulas in float64 (a row with no
    key to attend gives 0, lse NEG_INF and no gradient)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    sq, sk, scale = q.shape[2], k.shape[2], attn.softmax_scale(q.shape[-1])
    keep = attn.keep_mask(mask, sq, sk, causal, q.device)
    if keep is None:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    s = torch.where(keep, q @ k.transpose(-1, -2) * scale, attn.NEG_INF)
    live = keep.any(-1, keepdim=True)
    lse = torch.where(live, torch.logsumexp(s, -1, keepdim=True), attn.NEG_INF)
    p = torch.where(keep & live, torch.exp(s - lse), 0.0)
    out = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * out).sum(-1, keepdim=True))
    return {"out": out, "lse": lse[..., 0], "dq": ds @ k * scale,
            "dk": ds.transpose(-1, -2) @ q * scale, "dv": p.transpose(-1, -2) @ do}


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
    tf32 = [round_tf32(t) for t in (q, k, v, do)]
    faults = [(fault, (q, k, v, do), wkeep)
              for fault, wkeep in wrong_keeps(mask, s, causal, q.device).items()]
    faults.append(("products in single-pass TF32", tf32, keep))
    for fault, (wq, wk, wv, wdo), wkeep in faults:
        wout, wlse = attn.masked_fwd(wq, wk, wv, wkeep)
        wrong = {"out": wout, "lse": wlse, **dict(zip(
            ("dq", "dk", "dv"), attn.masked_bwd(wq, wk, wv, wkeep, out, lse, wdo)))}
        res["wrong"][fault] = {
            "errors": {n: float((wrong[n].double() - want[n].double()).abs().max())
                       for n in want},
            "rejected": all(not _close(wrong[n], want[n], TOLS[n]) for n in want)}
    res["ok"] = all(res["within"].values()) and all(
        w["rejected"] for w in res["wrong"].values())
    return res
