"""The port's fused embedding update (host prep and the plain versions of
the two update kernels) against the JAX package: its ``host_prep_group``
and its Pallas kernels ``fused_bwd_adam`` / ``fused_bwd_rowwise_adagrad``
in interpret mode.  The JAX package packs 128/D vocab rows into a table
row; the port's tables are logical (V, D), so packed results are compared
after ``reshape(-1, D)[:V]``.  Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.kernels.pallas.embedding_update_tpu import (
    fused_bwd_adam,
    fused_bwd_rowwise_adagrad,
)
from recsys_tpu.train.streaming_embed import host_prep_group as jax_host_prep
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import embedding_update as emb_ref
from recsys_tpu_torch.train.streaming_embed import host_prep_group
from test_streaming_embed import _dense_reference

# sums of the same values in another order, against each other or against
# float64: the tolerances of tests/test_streaming_embed.py
P_TOL = dict(rtol=2e-4, atol=1e-7)
# a bf16 table is one bf16 rounding of an f32 result that the order moves
BF16_P_TOL = dict(rtol=8e-3, atol=1e-6)


def _pad8(n):
    return (n + 7) // 8 * 8


def _ids(rng, vocab, n, hot):
    if hot:  # three hot ids take every occurrence
        return (rng.integers(0, 3, n) * 7).astype(np.int32)
    return rng.integers(0, vocab, n).astype(np.int32)


# -- (a) host prep ------------------------------------------------------------
@pytest.mark.parametrize("n, vocab, pack, block, ch, hot", [
    (1000, 5000, 8, 64, 128, False),
    (513, 100, 4, 8, 32, False),
    (256, 7, 1, 8, 64, False),
    (700, 1000, 1, 96, 64, False),
    (4096, 300, 1, 16, 256, True),
    (4096, 300, 8, 8, 32, True),
    (10, 100_000, 1, 512, 256, False),
    (16384, 300_000, 1, 512, 256, False),  # keys past 2^16
])
def test_host_prep_is_bit_equal_to_jax(n, vocab, pack, block, ch, hot):
    rng = np.random.default_rng(n + vocab)
    ids = _ids(rng, vocab, n, hot)
    vp = _pad8(-(-vocab // pack)) if pack > 1 else vocab
    want = jax_host_prep(ids, pack=pack, vp=vp, block=block, ch=ch, use_native=False)
    got = host_prep_group(ids, pack=pack, vp=vp, block=block, ch=ch)
    for name, g, w in zip(("ids2d", "idx", "cptr"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# -- (b) the plain updates against the Pallas kernels ------------------------
def _state(rng, rows, wide, fresh):
    p = rng.uniform(-0.05, 0.05, (rows, wide)).astype(np.float32)
    if fresh:
        return p, np.zeros_like(p), np.zeros_like(p)
    return (p, (rng.standard_normal((rows, wide)) * 1e-3).astype(np.float32),
            rng.uniform(1e-8, 1e-4, (rows, wide)).astype(np.float32))


def _unpack(a, d, vocab):
    return np.asarray(a).astype(np.float32).reshape(-1, d)[:vocab]


CASES = {
    # id: (vocab, pack, d, n, jax block, port block, wd, hot, p dtype, mm_bf16)
    "pack1": (512, 1, 16, 256, 16, 16, 0.0, False, "f32", True),
    "pack1-f32-sums": (512, 1, 16, 256, 16, 16, 0.0, False, "f32", False),
    "pack8": (500, 8, 16, 256, 16, 64, 0.0, False, "f32", True),
    "pack8-wd": (500, 8, 16, 256, 16, 48, 0.01, False, "f32", False),
    "pack8-bf16-table": (500, 8, 16, 256, 16, 64, 0.0, False, "bf16", True),
    "pack1-bf16-table-wd": (256, 1, 8, 300, 32, 32, 0.01, False, "bf16", False),
    # the row widths of the card's AdaGrad tests (lanes across a row at D = 8
    # and 32, a warp a row at D = 12)
    "pack1-d8": (512, 1, 8, 256, 16, 16, 0.0, False, "f32", True),
    "pack1-d12-wd": (320, 1, 12, 300, 16, 32, 0.01, False, "f32", False),
    "pack1-d32-bf16-table": (256, 1, 32, 200, 16, 16, 0.0, False, "bf16", True),
}


def _run(case, kind):
    vocab, pack, d, n, jblock, tblock, wd, hot, pdt, mm_bf16 = CASES[case]
    rng = np.random.default_rng(len(case))
    vp = _pad8(-(-vocab // pack)) if pack > 1 else vocab
    ids = _ids(rng, vocab, n, hot)
    cot = (rng.standard_normal((n, d)) * 1e-2).astype(np.float32)
    p, m, v = _state(rng, vp, pack * d, fresh=False)
    acc = rng.uniform(0, 1e-4, (vp, pack)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if pdt == "bf16" else (jnp.float32,
                                                                     torch.float32)
    i2, ix, cp = jax_host_prep(ids, pack=pack, vp=vp, block=jblock, ch=64,
                               use_native=False)
    kw = dict(block=jblock, ch=64, pack=pack, d=d, wd=wd, mm_bf16=mm_bf16,
              interpret=True)
    jargs = (jnp.asarray(cot[ix]), jnp.asarray(i2), jnp.asarray(cp))
    if kind == "adam":
        want = fused_bwd_adam(jnp.asarray(p, jdt), jnp.asarray(m), jnp.asarray(v), *jargs,
                              jnp.int32(3), lr=1e-3, **kw)
    else:
        want = fused_bwd_rowwise_adagrad(jnp.asarray(p, jdt), jnp.asarray(acc), *jargs,
                                         1e-3, **kw)

    t2, tx, tc = host_prep_group(ids, vp=vocab, block=tblock, ch=64)
    targs = (torch.from_numpy(cot[tx]), torch.from_numpy(t2), torch.from_numpy(tc))
    tp = torch.from_numpy(_unpack(np.asarray(jnp.asarray(p, jdt), np.float32), d,
                                  vocab).copy()).to(tdt)
    if kind == "adam":
        tm, tv = (torch.from_numpy(_unpack(a, d, vocab).copy()) for a in (m, v))
        dispatch.fused_embedding_adam(tp, tm, tv, *targs, 3, block=tblock, lr=1e-3,
                                      wd=wd, mm_bf16=mm_bf16)
        got = (tp, tm, tv)
    else:
        ta = torch.from_numpy(acc.reshape(-1)[:vocab].copy())
        dispatch.fused_embedding_rowwise_adagrad(tp, ta, *targs, block=tblock, lr=1e-3,
                                                 wd=wd, mm_bf16=mm_bf16)
        got = (tp, ta)
    return got, want, d, vocab, pdt


@pytest.mark.parametrize("case", list(CASES))
def test_plain_adam_matches_pallas_interpret(case):
    got, want, d, vocab, pdt = _run(case, "adam")
    assert got[0].dtype == (torch.bfloat16 if pdt == "bf16" else torch.float32)
    for name, g, w in zip("pmv", got, want):
        tol = BF16_P_TOL if name == "p" and pdt == "bf16" else P_TOL
        np.testing.assert_allclose(g.float().numpy(), _unpack(w, d, vocab), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_rowwise_adagrad_matches_pallas_interpret(case):
    got, want, d, vocab, pdt = _run(case, "adagrad")
    # as tests/test_streaming_embed.py::test_fused_rowwise_adagrad_matches_sparse_path
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]).reshape(-1)[:vocab],
                               rtol=1e-4, atol=1e-9)
    tol = BF16_P_TOL if pdt == "bf16" else dict(rtol=1e-3, atol=2e-7)
    np.testing.assert_allclose(got[0].float().numpy(), _unpack(want[0], d, vocab), **tol)


def test_plain_adam_hot_ids_first_step_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    vocab, pack, d, n = 300, 8, 16, 256
    vp = _pad8(-(-vocab // pack))
    ids = _ids(rng, vocab, n, hot=True)
    cot = np.asarray(jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
                     .astype(jnp.float32))
    p, m, v = _state(rng, vp, pack * d, fresh=True)
    i2, ix, cp = jax_host_prep(ids, pack=pack, vp=vp, block=8, ch=32, use_native=False)
    want = fused_bwd_adam(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                          jnp.asarray(cot[ix]), jnp.asarray(i2), jnp.asarray(cp),
                          jnp.int32(1), block=8, ch=32, pack=pack, d=d, wd=0.01,
                          mm_bf16=True, interpret=True)
    t2, tx, tc = host_prep_group(ids, vp=vocab, block=32, ch=32)
    got = [torch.from_numpy(_unpack(a, d, vocab).copy()) for a in (p, m, v)]
    emb_ref.fused_adam(*got, torch.from_numpy(cot[tx]), torch.from_numpy(t2),
                       torch.from_numpy(tc), 1, block=32, lr=1e-3, wd=0.01)
    # first-step Adam is sign(g)-like: duplicates summed in another order
    # can flip a sum near zero, so m and v tightly and p by share, as
    # tests/test_streaming_embed.py::test_fused_adam_weight_decay_and_skew
    np.testing.assert_allclose(got[1].numpy(), _unpack(want[1], d, vocab), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), _unpack(want[2], d, vocab), rtol=1e-4,
                               atol=1e-9)
    bad = np.abs(got[0].numpy() - _unpack(want[0], d, vocab)) > 1e-5
    assert bad.mean() < 0.001, f"{bad.sum()} divergent update cells"


@pytest.mark.parametrize("vocab, block", [(1000, 96), (37, 16), (5, 512)])
def test_plain_adam_ragged_block_matches_dense_reference(vocab, block):
    """A last block shorter than ``block`` (which the TPU kernel's tests
    never take): the f64 dense scatter-add + Adam reference of
    tests/test_streaming_embed.py."""
    rng = np.random.default_rng(vocab)
    d, n = 8, 700
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
                     .astype(jnp.float32))
    p, m, v = _state(rng, vocab, d, fresh=False)
    blk = min(block, vocab)
    i2, ix, cp = host_prep_group(ids, vp=vocab, block=blk, ch=64)
    got = [torch.from_numpy(a.copy()) for a in (p, m, v)]
    emb_ref.fused_adam(*got, torch.from_numpy(cot[ix]), torch.from_numpy(i2),
                       torch.from_numpy(cp), 3, block=blk, lr=1e-3, wd=0.01)
    want = _dense_reference(p.astype(np.float64), m.astype(np.float64),
                            v.astype(np.float64), cot, ids, 3, pack=1, d=d, wd=0.01)
    for name, g, w in zip("pmv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **P_TOL, err_msg=name)


def test_sentinels_and_foreign_ids_add_nothing():
    """An id in a chunk window of another block, and the sentinel, leave
    the gradient untouched: only the owning block sums a row."""
    ids2d = torch.tensor([[0, 5], [3, 8]], dtype=torch.int32)  # block 4, nb 2
    cptr = torch.tensor([0, 1, 2], dtype=torch.int32)  # chunk 1 -> block 1
    cot = torch.ones((4, 2))
    g = emb_ref.block_gradient(8, cot, ids2d, cptr, block=4, mm_bf16=False)
    want = torch.zeros((8, 2))
    want[0] = 1  # id 0 in block 0's chunk; id 5 there is block 1's: dropped
    # chunk 1 (block 1): id 3 is block 0's, dropped; 8 is the sentinel
    torch.testing.assert_close(g, want)


@pytest.mark.parametrize("bad, err", [
    (lambda: dispatch.fused_embedding_adam(
        torch.zeros(8, 2), torch.zeros(8, 2), torch.zeros(8, 3),
        torch.zeros(4, 2), torch.zeros((2, 2), dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32), 1, block=4, lr=1e-3), ValueError),
    (lambda: dispatch.fused_embedding_adam(
        torch.zeros(8, 2), torch.zeros(8, 2), torch.zeros(8, 2),
        torch.zeros(4, 2), torch.zeros((2, 2), dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 1, block=4, lr=1e-3), ValueError),
    (lambda: dispatch.fused_embedding_rowwise_adagrad(
        torch.zeros(8, 2).double(), torch.zeros(8), torch.zeros(4, 2),
        torch.zeros((2, 2), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
        block=4, lr=1e-3), TypeError),
    (lambda: dispatch.fused_embedding_rowwise_adagrad(
        torch.zeros(8, 2), torch.zeros(8), torch.zeros(4, 2),
        torch.zeros((2, 2), dtype=torch.int64), torch.zeros(3, dtype=torch.int32),
        block=4, lr=1e-3), TypeError),
])
def test_update_wrappers_refuse_bad_inputs(bad, err):
    with pytest.raises(err):
        bad()
