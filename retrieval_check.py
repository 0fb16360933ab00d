"""How the pooled-gather and top-k kernels are held against their plain
versions, shared by chip_smoke.py and tests/test_torch_cuda.py (imports no
JAX).

Pooled gather.  Kernel and plain version add the same f32 rows in another
order, so an output element may differ by a few roundings of the sum of its
terms' magnitudes: the limit is ``POOL_RTOL`` times that sum (plus
``POOL_ATOL``), at least 20 times what two orders of 50 terms can make.  The
wrong result, the sum with each example's last real position left out (what
a kernel that drops the ragged end of its loop would give), must fail it.

Top-k.  The kernel's scores are split-TF32 products on the tensor cores
(each operand split into a TF32 big part and a small part, three products
a k-step of 8 columns accumulated into the score), the plain version's an
exact f32 matrix product in its own order: a score may differ by about
2⁻²⁰ of ‖q‖·‖x‖ (the dropped small·small product, the small parts' lost
low bits and the tensor cores' rounding toward zero) plus the f32
roundings of either sum, so the limit on a score is
``SCORE_RTOL``·‖q‖·max‖x‖.  Two items whose
scores lie within that limit may swap places, so ranks are compared
through scores: at every rank the plain score of the kernel's item must lie
within the limit of the plain version's value there, the kernel's values
within the limit of the plain ones, and each returned value within the
limit of its item's score recomputed from the inputs in float64.  Exact
ties (duplicated item rows, placed where a tile or a catalog split ends)
give bit-equal scores on both sides, so there the lower id must come first
with no tolerance.  Two wrong results must fail: the plain top-k with its
k-th entry swapped for the (k+1)-th, and the plain top-k scored in
single-pass TF32 (each operand rounded to TF32 once), whose scores are
about 2⁻¹¹ of ‖q‖·‖x‖ off.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import embedding as emb_ref
from recsys_tpu_torch.kernels import topk as topk_ref

POOL_RTOL, POOL_ATOL = 1e-5, 1e-6
SCORE_RTOL = 1e-5


def pooled_inputs(rng, b, length, v, d, dtype, skewed, device):
    """A (v, d) table in ``dtype`` and (b, length) rows and mask: histories
    of 0..length real positions padded in front (every fourth empty), ids
    uniform or Zipf-skewed (hot ids repeat within a row)."""
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32)).to(device, dtype)
    if skewed:
        rows = np.minimum(rng.zipf(1.3, (b, length)) - 1, v - 1)
    else:
        rows = rng.integers(0, v, (b, length))
    lens = rng.integers(1, length + 1, b)
    lens[::4] = 0
    mask = np.arange(length)[None, :] >= length - lens[:, None]
    rows[~mask] = 0
    return (table, torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(mask).to(device))


def unaligned(table):
    """A copy of ``table`` whose storage starts one element past a 16-byte
    boundary, for the kernels' element-a-lane path."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype, device=table.device)
    out = flat[1:].view(table.shape)
    out.copy_(table)
    return out


def _pool_close(got, want, scale) -> bool:
    return got.shape == want.shape and bool(
        (((got.double() - want.double()).abs() <= POOL_RTOL * scale + POOL_ATOL)
         & torch.isfinite(got)).all())


def check_pooled(table, rows, mask, kernel) -> dict:
    """The pooled-gather ``kernel`` (the dispatch wrapper) against the plain
    version on one case: the largest error and its share of the limit,
    whether it is within it, and whether the wrong result is rejected."""
    got = kernel(table, rows, mask)
    want = emb_ref.pooled_gather(table, rows, mask)
    scale = emb_ref.pooled_gather(table.abs(), rows, mask).double()
    last = mask.shape[1] - 1 - mask.flip(1).int().argmax(1)  # last real position
    drop = mask.clone()
    drop[torch.arange(mask.shape[0], device=mask.device), last] = False
    wrong = emb_ref.pooled_gather(table, rows, drop)
    err = (got.double() - want.double()).abs()
    empty = ~mask.any(1)
    res = {"max_abs_err": float(err.max()),
           "worst_share_of_limit": float((err / (POOL_RTOL * scale + POOL_ATOL)).max()),
           "within": _pool_close(got, want, scale),
           "empty_rows_zero": bool((got[empty] == 0).all()),
           "empty_rows": int(empty.sum()),
           "wrong_last_id_left_out_max_abs_err": float((wrong - want).abs().max()),
           "wrong_rejected": not _pool_close(wrong, want, scale)}
    res["ok"] = res["within"] and res["empty_rows_zero"] and res["wrong_rejected"]
    return res


def topk_inputs(rng, nq, n, d, device, normalize=True, duplicates=3, dup_at=None):
    """Queries (nq, d) and items (n, d), unit vectors or standard normal;
    item 3's row (the last item's in a catalog of 3 or fewer) is copied to
    ``duplicates`` - 1 higher ids spread over the catalog, or to the ids
    ``dup_at`` (exact ties), and query 0 is that row, so the copies lead its
    top-k."""
    q = rng.standard_normal((nq, d), dtype=np.float32)
    items = rng.standard_normal((n, d), dtype=np.float32)
    if normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        items /= np.linalg.norm(items, axis=1, keepdims=True)
    if dup_at is None:
        dup_at = [int(j) for j in np.linspace(n // 2, n - 1, duplicates - 1)]
    base = min(3, n - 1)
    dup = [base] + sorted({int(j) for j in dup_at if base < j < n})
    items[dup] = items[base]
    q[0] = items[base]
    return torch.from_numpy(q).to(device), torch.from_numpy(items).to(device), dup


def boundary_ids(n, tile, per_split) -> list[int]:
    """Ids on both sides of the first tile boundary and of every catalog
    split boundary below n (the kernel's plan: ``tile`` items a tile,
    ``per_split`` a split), for duplicated rows."""
    ids = {tile - 1, tile}
    for s in range(per_split, n, per_split):
        ids |= {s - 1, s}
    return sorted(j for j in ids if 3 < j < n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def score_limit(q, items) -> torch.Tensor:
    """(Q, 1): the limit on a score of each query."""
    return SCORE_RTOL * q.norm(dim=1, keepdim=True) * items.norm(dim=1).max()


def topk_agrees(v, i, want_v, q, items, limit) -> bool:
    """Values within ``limit`` of the plain ones, and the plain score of
    each returned item within ``limit`` of the plain value at its rank."""
    if v.shape != want_v.shape or not bool(torch.isfinite(v).all()):
        return False
    if bool(((i < 0) | (i >= items.shape[0])).any()):
        return False
    plain_scores = torch.einsum("qd,qkd->qk", q, items[i.long()])
    return bool((((v - want_v).abs() <= limit) &
                 ((plain_scores - want_v).abs() <= limit)).all())


def check_topk(q, items, k, kernel, dup=()) -> dict:
    """The top-k ``kernel`` (the dispatch wrapper) against the plain version
    on one case, by the rules of the module docstring."""
    v, i = kernel(q, items, k)
    want_v, want_i = topk_ref.topk_scores(q, items, k + 1)
    wrong_v, wrong_i = want_v[:, :k].clone(), want_i[:, :k].clone()
    wrong_v[:, -1], wrong_i[:, -1] = want_v[:, k], want_i[:, k]
    want_v, want_i = want_v[:, :k], want_i[:, :k]
    tf32_v, tf32_i = topk_ref.topk_scores(tf32(q), tf32(items), k)
    limit = score_limit(q, items)
    exact = torch.einsum("qd,qkd->qk", q.double(), items.double()[i.long()])
    res = {"max_abs_err": float((v - want_v).abs().max()),
           "indices_equal_share": float((i == want_i).double().mean()),
           "within": topk_agrees(v, i, want_v, q, items, limit),
           "recomputed_within": bool(((v.double() - exact).abs() <= limit.double()).all()),
           "distinct": bool((i.sort(1).values.diff(1) != 0).all()) if k > 1 else True,
           "wrong_kth_swapped_max_abs_err": float((wrong_v - want_v).abs().max()),
           "wrong_rejected": not topk_agrees(wrong_v, wrong_i, want_v, q, items, limit),
           "wrong_single_pass_tf32_max_abs_err": float((tf32_v - want_v).abs().max()),
           "wrong_single_pass_tf32_rejected": not topk_agrees(tf32_v, tf32_i, want_v, q, items,
                                                              limit)}
    # exact ties: a duplicated row's copies enter in id order, lower first
    ties_ok = True
    for a, b in zip(dup, dup[1:]):
        has_a, has_b = (i == a).any(1), (i == b).any(1)
        pos_a = (i == a).int().argmax(1)
        pos_b = (i == b).int().argmax(1)
        ties_ok &= bool((~has_b | (has_a & (pos_a < pos_b))).all())
    res["exact_ties_lower_id_first"] = ties_ok
    res["ok"] = all(res[key] for key in ("within", "recomputed_within", "distinct",
                                         "wrong_rejected", "wrong_single_pass_tf32_rejected",
                                         "exact_ties_lower_id_first"))
    return res
