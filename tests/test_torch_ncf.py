"""The port's NCF slice against the JAX package on the CPU: ``NCF.score``
(items (B,) and (B, N)) and ``forward`` from weights converted with
``ncf_params_from_jax``; three ``Trainer`` steps of the pairwise BCE
against the JAX ``Trainer``; ``build_ncf_dataset_fast`` and
``build_ncf_dataset`` bit-equal to JAX's from the same ratings and seed;
``sampled_softmax`` with shared and per-example negatives, log-Q and
accidental hits; the law of ``log_uniform_candidates`` (its draws come
from a ``torch.Generator``, so only the law can match); ``fit``'s
``eval_fn`` hook; and the ``Trainer``'s user and item id checks.

Tolerances: f32 on both sides, sums in another order: 1e-5 on logits,
losses and parameters; 1e-6 on ``sampled_softmax``'s loss; the data
bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data.movielens import build_ncf_dataset as jax_build_ncf_dataset
from recsys_tpu.data.movielens import synthetic_ratings as jax_synthetic_ratings
from recsys_tpu.data.realistic import build_ncf_dataset_fast as jax_build_ncf_fast
from recsys_tpu.data.realistic import realistic_ratings as jax_realistic_ratings
from recsys_tpu.models.match.ncf import NCF as JaxNCF
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu.train.metrics import hit_rate_ndcg_at_k as jax_hit_rate_ndcg_at_k
from recsys_tpu_torch.convert import ncf_params_from_jax
from recsys_tpu_torch.data.movielens import build_ncf_dataset, synthetic_ratings
from recsys_tpu_torch.data.realistic import build_ncf_dataset_fast, realistic_ratings
from recsys_tpu_torch.models.match.ncf import NCF
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.metrics import hit_rate_ndcg_at_k

TOL = dict(rtol=1e-5, atol=1e-5)
NU, NI = 60, 90


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, n, negs):
    return {"user": rng.integers(0, NU, n).astype(np.int32),
            "pos_item": rng.integers(0, NI, n).astype(np.int32),
            "neg_item": rng.integers(0, NI, (n, negs)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(seed=0, **kw):
    jm = JaxNCF(num_users=NU, num_items=NI, **kw)
    params = jm.init(jax.random.PRNGKey(seed), _jax(_batch(np.random.default_rng(0), 2, 3)))[
        "params"]
    tm = NCF(NU, NI, **kw)
    tm.load_state_dict(ncf_params_from_jax(_np_tree(params), tm))
    return jm, params, tm


@pytest.mark.parametrize("kw", [{}, dict(gmf_dim=8, mlp_dim=12, mlp_units=(24, 8))],
                         ids=["default", "narrow"])
def test_ncf_score_and_forward_match_jax(kw):
    jm, params, tm = _pair(**kw)
    batch = _batch(np.random.default_rng(1), 17, 5)
    want = jm.apply({"params": params}, _jax(batch))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
        for items in (batch["pos_item"], batch["neg_item"]):
            np.testing.assert_allclose(
                tm.score(torch.from_numpy(batch["user"]), torch.from_numpy(items)).numpy(),
                np.asarray(jm.apply({"params": params}, jnp.asarray(batch["user"]),
                                    jnp.asarray(items), method=jm.score)), **TOL)
    assert got.keys() == want.keys() == {"pos_logits", "neg_logits"}
    assert got["neg_logits"].shape == (17, 5) and got["pos_logits"].shape == (17,)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


def _loss(out, batch):
    return losses.pairwise_bce(out["pos_logits"], out["neg_logits"])


def _jax_loss(out, batch):
    return jax_losses.pairwise_bce(out["pos_logits"], out["neg_logits"])


def test_ncf_train_steps_match_jax():
    """Three Adam steps of the pairwise BCE: each loss and every parameter
    after each step within 1e-5."""
    jm, params, tm = _pair(seed=3)
    data = _batch(np.random.default_rng(2), 3 * 32, 4)
    jt = JaxTrainer(jm, loss_fn=_jax_loss, learning_rate=1e-3)
    jt.init({k: v[:2] for k, v in data.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    tt = Trainer(tm, loss_fn=_loss, learning_rate=1e-3, device="cpu")
    for s in range(3):
        batch = {k: v[s * 32:(s + 1) * 32] for k, v in data.items()}
        jt.state, jl, _ = jt._train_step(jt.state, _jax(batch), jax.random.PRNGKey(s))
        np.testing.assert_allclose(tt.train_step(batch).item(), float(jl), **TOL)
        want = ncf_params_from_jax(_np_tree(jt.state.params), tm)
        for name, w in want.items():
            np.testing.assert_allclose(tm.state_dict()[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{name} after step {s + 1}")


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _frame_columns(frame) -> dict:
    return {c: frame[c].to_numpy() for c in ("user_id", "item_id", "rating", "timestamp")}


@pytest.mark.parametrize("kw", [dict(), dict(train_neg_num=3, test_neg_num=20, trans_score=3,
                                             seed=7)], ids=["default", "options"])
def test_ncf_builders_are_bit_equal_to_jax(kw):
    frame = jax_realistic_ratings(num_users=400, num_items=300, seed=1)
    cols = realistic_ratings(num_users=400, num_items=300, seed=1)
    _equal(cols, _frame_columns(frame))
    jax_out = jax_build_ncf_fast(frame, **kw)
    got = build_ncf_dataset_fast(cols, **kw)
    assert got[:2] == jax_out[:2]
    for g, w in zip(got[2:], jax_out[2:]):
        _equal(g, w)
    frame = jax_synthetic_ratings(num_users=80, num_items=50, seed=2)
    jax_out = jax_build_ncf_dataset(frame, **kw)
    got = build_ncf_dataset(synthetic_ratings(num_users=80, num_items=50, seed=2), **kw)
    assert got[:2] == jax_out[:2]
    for g, w in zip(got[2:], jax_out[2:]):
        _equal(g, w)


@pytest.mark.parametrize("per_example", [False, True], ids=["shared", "per-example"])
@pytest.mark.parametrize("log_q, hits", [(False, False), (True, False), (True, True)],
                         ids=["plain", "logq", "logq-hits"])
def test_sampled_softmax_matches_jax(per_example, log_q, hits):
    rng = np.random.default_rng(4)
    b, s, d = 12, 7, 6
    q, pos = rng.normal(size=(2, b, d)).astype(np.float32)
    neg = rng.normal(size=((b, s, d) if per_example else (s, d))).astype(np.float32)
    kw = {}
    if log_q:
        kw["pos_log_q"] = np.log(rng.uniform(0.01, 0.2, b)).astype(np.float32)
        kw["neg_log_q"] = np.log(rng.uniform(0.01, 0.2, neg.shape[:-1])).astype(np.float32)
    if hits:
        kw["pos_ids"] = rng.integers(0, 5, b).astype(np.int32)
        kw["neg_ids"] = rng.integers(0, 5, neg.shape[:-1]).astype(np.int32)
        assert (kw["neg_ids"] == kw["pos_ids"][:, None]).any()  # some hits to mask
    want = jax_losses.sampled_softmax(jnp.asarray(q), jnp.asarray(pos), jnp.asarray(neg),
                                      temperature=0.5,
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    got = losses.sampled_softmax(torch.from_numpy(q), torch.from_numpy(pos),
                                 torch.from_numpy(neg), temperature=0.5,
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_log_uniform_candidates_follow_the_law():
    """Ids in range, ``log_p`` from the JAX package's formula at each id,
    log1p(1/(k + 1)) − log(n + 1) (which is not log P(k): the port mirrors
    it), and the histogram of 400,000 draws within 5 binomial sd of P(k) =
    log1p(1/(k + 1)) / log(n + 1) at every id (the JAX sampler's law,
    checked the same way on its own draws)."""
    n, draws = 50, 400_000
    ids, log_p = losses.log_uniform_candidates(torch.Generator().manual_seed(0), n, (draws,),
                                               offset=1)
    jids, jlog_p = jax_losses.log_uniform_candidates(jax.random.PRNGKey(0), n, (draws,),
                                                     offset=1)
    p = np.log1p(1.0 / (np.arange(n) + 1.0)) / np.log(n + 1.0)
    for got, lp in ((ids.numpy(), log_p.numpy()), (np.asarray(jids), np.asarray(jlog_p))):
        assert got.dtype == np.int32 and lp.dtype == np.float32
        assert got.min() >= 1 and got.max() <= n
        np.testing.assert_allclose(lp, np.log1p(1.0 / got) - np.log(n + 1.0), rtol=1e-6,
                                   atol=1e-6)
        counts = np.bincount(got - 1, minlength=n)
        assert (np.abs(counts - draws * p) <= 5 * np.sqrt(draws * p * (1 - p))).all()


def test_fit_eval_fn_gives_the_jax_history():
    """``fit(eval_fn, eval_every=2)`` over 4 epochs: both Trainers' histories
    hold ``loss`` and ``val_loss`` a epoch and HR@10/NDCG@10 every second
    epoch, in [0, 1]; the hook reads the trainer it is given."""
    nu, ni, train, _, test = build_ncf_dataset(synthetic_ratings(num_users=60, num_items=40))

    def jax_eval(trainer):
        out = trainer.predict(test)
        hr, ndcg = jax_hit_rate_ndcg_at_k(jnp.asarray(out["pos_logits"]),
                                          jnp.asarray(out["neg_logits"]), k=10)
        return {"HR@10": float(hr), "NDCG@10": float(ndcg)}

    seen = []

    def eval_fn(trainer):
        seen.append(trainer)
        out = trainer.predict(test)
        hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)
        return {"HR@10": hr, "NDCG@10": ndcg}

    jt = JaxTrainer(JaxNCF(num_users=nu, num_items=ni), loss_fn=_jax_loss)
    want = jt.fit(train, batch_size=64, epochs=4, val_data=test, eval_fn=jax_eval,
                  eval_every=2, verbose=False)
    tt = Trainer(NCF(nu, ni), loss_fn=_loss, device="cpu")
    got = tt.fit(train, batch_size=64, epochs=4, val_data=test, eval_fn=eval_fn, eval_every=2,
                 verbose=False)
    assert got.keys() == want.keys() == {"loss", "val_loss", "HR@10", "NDCG@10"}
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()} == \
        {"loss": 4, "val_loss": 4, "HR@10": 2, "NDCG@10": 2}
    assert seen == [tt, tt]
    assert all(0.0 <= v <= 1.0 for k in ("HR@10", "NDCG@10") for v in got[k])


def test_trainer_refuses_user_and_item_ids_outside_their_tables():
    tr = Trainer(NCF(NU, NI), loss_fn=_loss, device="cpu")
    data = _batch(np.random.default_rng(5), 40, 3)
    for key, bad in (("user", NU), ("pos_item", -1), ("neg_item", NI)):
        broken = {k: v.copy() for k, v in data.items()}
        broken[key].reshape(-1)[7] = bad
        with pytest.raises(ValueError, match=f"{key} ids outside"):
            tr.predict(broken, batch_size=16)
    # a user id may reach num_items and an item id num_users: each key has its own table
    ok = {k: v.copy() for k, v in data.items()}
    ok["user"][0], ok["pos_item"][0] = NU - 1, NI - 1
    assert tr.predict(ok, batch_size=16)["pos_logits"].shape == (40,)
