"""The port's pooled gather and retrieval against the JAX package on the
CPU: the plain pooled gather (through ``SegmentSumGather``, forward and
gradient) against ``dispatch.segment_sum_gather(interpret=True)``, which
runs the Pallas kernel in interpret mode; the plain top-k against
``topk_scores_pallas(interpret=True)``; ``topk_scores``,
``topk_scores_streaming`` and ``BruteForceIndex`` against the JAX ones; the
sampled-softmax loss, logQ and recall@K.  Inputs come from numpy with a
seed; the interpret-mode cases stay small (B <= 16, L <= 8).

Tolerances: f32 on both sides, sums in another order: 1e-6 on pooled
vectors and gradients of O(1) terms (a handful of adds), 1e-5 on scores
(D-term dot products of O(1) values), 1e-6 relative on losses.  Indices
must be equal: the inputs have no near-ties except the exact ones made on
purpose, which both sides order by the lower id."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.kernels.pallas.topk_tpu import topk_scores_pallas
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train import metrics as jax_metrics
from recsys_tpu.train import retrieval as jax_retrieval
import retrieval_check
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import embedding as emb_ref
from recsys_tpu_torch.kernels import topk as topk_ref
from recsys_tpu_torch.train import losses, retrieval
from recsys_tpu_torch.train.metrics import recall_at_k

POOL_TOL = dict(rtol=1e-6, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _pool_case(seed, b=12, length=8, v=40, d=8):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    rows = rng.integers(0, v, (b, length)).astype(np.int32)
    rows[:, ::3] = rows[:, :1]  # the same row twice in an example
    mask = rng.random((b, length)) > 0.4
    mask[2] = False   # an example with no real position
    mask[5] = True
    rows[~mask] = 0   # padding holds the pad id 0, a real row of the table
    return table, rows, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean", "sqrtn"])
def test_pooled_gather_matches_pallas_interpret(mode, dtype):
    table, rows, mask = _pool_case(0)
    tt = torch.from_numpy(table)
    if dtype == "bf16":  # both read the bf16 values as f32
        tt = tt.bfloat16()
        table = tt.float().numpy()
    want = jax_dispatch.segment_sum_gather(jnp.asarray(table), jnp.asarray(rows),
                                           jnp.asarray(mask), mode=mode, interpret=True)
    got = dispatch.segment_sum_gather(tt, torch.from_numpy(rows), torch.from_numpy(mask), mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)
    assert not got[2].any()  # no real position: 0 whatever the mode
    # the reference op, gather then pool
    ref = emb_ref.segment_sum_gather(tt.float(), torch.from_numpy(rows),
                                     torch.from_numpy(mask), mode)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **POOL_TOL)


@pytest.mark.parametrize("mode", ["sum", "mean", "sqrtn"])
def test_pooled_gather_gradient_matches_jax_grad(mode):
    table, rows, mask = _pool_case(1)
    w = np.random.default_rng(2).standard_normal((rows.shape[0], table.shape[1])).astype(
        np.float32)

    def jloss(t):
        out = jax_dispatch.segment_sum_gather(t, jnp.asarray(rows), jnp.asarray(mask),
                                              mode=mode, interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    (dispatch.segment_sum_gather(tt, torch.from_numpy(rows), torch.from_numpy(mask), mode)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), **POOL_TOL)
    # every occurrence of the pad id 0 is masked out here, so its row gets
    # no gradient
    assert not ((rows == 0) & mask).any() and not tt.grad[0].any()


def test_pooled_gather_refuses_an_unknown_mode():
    t = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="pooling mode"):
        dispatch.segment_sum_gather(t, torch.zeros(1, 3, dtype=torch.int32),
                                    torch.ones(1, 3, dtype=torch.bool), "nope")


def _topk_case(seed, q, n, d):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    items = rng.standard_normal((n, d)).astype(np.float32)
    items[n // 2] = items[3]   # exact ties: the same row at three ids
    items[n - 1] = items[3]
    return qs, items


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("q, n, d", [(37, 201, 12), (8, 64, 32), (3, 17, 5)])
def test_plain_topk_matches_pallas_interpret(q, n, d, k):
    qs, items = _topk_case(k, q, n, d)
    wv, wi = topk_scores_pallas(jnp.asarray(qs), jnp.asarray(items), k=k, blk_q=8,
                                tile_n=32, interpret=True)
    gv, gi = dispatch.topk_scores_fused(torch.from_numpy(qs), torch.from_numpy(items), k)
    assert gi.dtype == torch.int32 and gv.shape == (q, k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **SCORE_TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_plain_topk_orders_exact_ties_by_the_lower_id():
    qs = np.ones((2, 4), np.float32)
    items = np.zeros((40, 4), np.float32)
    items[[30, 5, 17]] = 1.0  # three equal best scores
    items[[9, 2]] = -0.0      # -0.0 scores tie with +0.0 ones
    v, i = topk_ref.topk_scores(torch.from_numpy(qs), torch.from_numpy(items), 6, tile=16)
    np.testing.assert_array_equal(i[0].numpy(), [5, 17, 30, 0, 1, 2])
    np.testing.assert_array_equal(v[0].numpy(), [4, 4, 4, 0, 0, 0])


def test_topk_kernel_domain():
    q, items = torch.zeros(2, 4), torch.zeros(20, 4)
    for k, n in ((17, 20), (0, 20), (5, 5)):
        assert not topk_ref.in_domain(k, n, 4)
        with pytest.raises(ValueError, match="1 <= k <= 16"):
            dispatch.topk_scores_fused(q, items[:n], k)
    # D padded to a multiple of 4 must lie in [4, 128]
    for d, takes in ((1, True), (4, True), (12, True), (125, True), (128, True),
                     (129, False), (132, False), (0, False)):
        assert topk_ref.in_domain(10, 20, d) == takes, d
    with pytest.raises(ValueError, match="does not take D=129"):
        dispatch.topk_scores_fused(torch.zeros(2, 129), torch.zeros(20, 129), 10)


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("nq, n, d", [(37, 300, 12), (5, None, 30), (9, 400, 128),
                                      (130, 1000, 4)])
def test_retrieval_check_holds_the_plain_topk_and_rejects_wrong_results(k, nq, n, d):
    """check_topk, as the card runs it, with the wrapper's plain version on
    the CPU: within every limit, exact ties (rows copied across tile and
    split boundaries) lower id first, and both wrong results (the k-th entry
    swapped, single-pass TF32 scores) rejected."""
    n = n or k + 1
    dup = retrieval_check.boundary_ids(n, 64, 96)
    q, items, dup = retrieval_check.topk_inputs(np.random.default_rng(nq + k), nq, n, d, "cpu",
                                                dup_at=dup)
    res = retrieval_check.check_topk(q, items, k, dispatch.topk_scores_fused, dup)
    assert res["ok"], res
    assert res["indices_equal_share"] == 1.0 and res["max_abs_err"] == 0.0


def test_retrieval_check_helpers():
    # 10 mantissa bits: the spacing at 1 is 2^-10
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 2.0**-11,
                      -(1.0 + 3 * 2.0**-11), 3.0e-30])
    got = retrieval_check.tf32(x)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    # ties round away from zero, as cvt.rna does
    assert got[:5].tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10, -(1.0 + 2.0**-9)]
    assert retrieval_check.boundary_ids(300, 64, 128) == [63, 64, 127, 128, 255, 256]
    assert retrieval_check.boundary_ids(11, 64, 64) == []
    table = torch.arange(12.0).view(4, 3)
    t = retrieval_check.unaligned(table)
    assert t.data_ptr() % 16 == 4 and t.is_contiguous() and torch.equal(t, table)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 50, 64, 65, 200])
@pytest.mark.parametrize("d", [4, 12, 32, 33, 128, 130])
def test_retrieval_check_holds_the_plain_pooled_gather(length, d):
    """check_pooled at the card checks' geometries with the wrapper's plain
    version on the CPU: within the limit, empty histories 0, and the sum
    without each history's last id rejected (f32 uniform ids, a bf16 table
    with Zipf ids, an unaligned f32 table)."""
    for dtype, skewed, shift in ((torch.float32, False, False), (torch.bfloat16, True, False),
                                 (torch.float32, True, True)):
        table, rows, mask = retrieval_check.pooled_inputs(np.random.default_rng(length + d), 9,
                                                          length, 300, d, dtype, skewed, "cpu")
        if shift:
            table = retrieval_check.unaligned(table)
        res = retrieval_check.check_pooled(table, rows, mask, dispatch.pooled_gather)
        assert res["within"] and res["empty_rows_zero"] and res["empty_rows"] > 0, res
        assert length == 1 or res["wrong_rejected"], res


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k", [10, 40])
def test_topk_scores_matches_jax(k, normalize):
    qs, items = _topk_case(3, 29, 300, 16)
    wv, wi = jax_retrieval.topk_scores(jnp.asarray(qs), jnp.asarray(items), k=k,
                                       normalize=normalize)
    gv, gi = retrieval.topk_scores(torch.from_numpy(qs), torch.from_numpy(items), k=k,
                                   normalize=normalize)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **SCORE_TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [10, 16, 25])
def test_topk_scores_streaming_matches_jax(k):
    qs, items = _topk_case(4, 21, 1000, 8)
    wv, wi = jax_retrieval.topk_scores_streaming(jnp.asarray(qs), jnp.asarray(items), k=k,
                                                 tile=128)
    gv, gi = retrieval.topk_scores_streaming(torch.from_numpy(qs), torch.from_numpy(items),
                                             k=k, tile=128)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **SCORE_TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_brute_force_index_matches_jax():
    qs, items = _topk_case(5, 10, 90, 8)
    jax_index = jax_retrieval.BruteForceIndex(8, normalize=True)
    index = retrieval.BruteForceIndex(8, normalize=True, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        index.search(qs, 5)
    for part in (items[:50], items[50:]):
        jax_index.add(part)
        index.add(part)
    assert index.ntotal == jax_index.ntotal == 90
    wv, wi = jax_index.search(qs, 5)
    gv, gi = index.search(qs, 5)
    assert isinstance(gv, np.ndarray) and isinstance(gi, np.ndarray)
    np.testing.assert_allclose(gv, wv, **SCORE_TOL)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("temperature", [1.0, 0.05])
@pytest.mark.parametrize("log_q", [False, True])
def test_in_batch_sampled_softmax_matches_jax(log_q, temperature):
    rng = np.random.default_rng(6)
    u = rng.standard_normal((16, 8)).astype(np.float32)
    i = rng.standard_normal((16, 8)).astype(np.float32)
    counts = rng.integers(0, 50, 30)
    ids = rng.integers(0, 30, 16)
    jq = jax_losses.popularity_log_q(jnp.asarray(counts))
    tq = losses.popularity_log_q(counts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6)
    want = jax_losses.in_batch_sampled_softmax(
        jnp.asarray(u), jnp.asarray(i), jq[ids] if log_q else None, temperature=temperature)
    got = losses.in_batch_sampled_softmax(
        torch.from_numpy(u), torch.from_numpy(i), tq[torch.from_numpy(ids)] if log_q else None,
        temperature=temperature)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(7)
    retrieved = rng.integers(0, 20, (50, 10))
    true = rng.integers(0, 20, 50)
    assert recall_at_k(retrieved, true) == jax_metrics.recall_at_k(retrieved, true)
