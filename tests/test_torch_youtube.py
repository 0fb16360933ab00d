"""The port's YoutubeDNN slice against the JAX package on the CPU: the
numpy data functions (bit-equal), ``StackedEmbedding``'s varlen lookups,
YoutubeDNN's user and item embeddings from weights converted from a JAX
init (the JAX user table row-packed, the port's logical), three
``Trainer.train_step``s with the logQ-corrected in-batch softmax against the
JAX ``Trainer``, and the ``cli youtube`` flow (train, then recall@10 over
the whole catalog) on both packages.  Inputs come from numpy with a seed.

Tolerances: f32 on both sides, sums in another order: 1e-5 on embeddings
and losses; parameters and Adam moments after three steps as
tests/test_torch_sasrec.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.features import FeatureSchema as JaxSchema
from recsys_tpu.core.features import SparseFeature as JaxSparse
from recsys_tpu.core.features import VarLenSparseFeature as JaxVarLen
from recsys_tpu.data.movielens import build_seq_retrieval_dataset as jax_build
from recsys_tpu.data.movielens import synthetic_ratings as jax_synthetic_ratings
from recsys_tpu.data.realistic import realistic_ratings as jax_realistic_ratings
from recsys_tpu.models.match.youtube_dnn import YoutubeDNN as JaxYoutubeDNN
from recsys_tpu.ops.embedding import StackedEmbedding as JaxStackedEmbedding
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train import retrieval as jax_retrieval
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu.train.metrics import recall_at_k as jax_recall_at_k
from recsys_tpu_torch.convert import _unpack_tables, youtube_dnn_params_from_jax
from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature, VarLenSparseFeature
from recsys_tpu_torch.data.movielens import build_seq_retrieval_dataset, synthetic_ratings
from recsys_tpu_torch.data.realistic import realistic_ratings
from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN
from recsys_tpu_torch.ops.attention import Dropout
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.mlp import MLP
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.metrics import recall_at_k
from recsys_tpu_torch.train.retrieval import topk_scores

TOL = dict(rtol=1e-5, atol=1e-5)
EMBED, MAXLEN = 32, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- data ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(num_users=300, num_items=500, seed=3),
                                dict(num_users=700, num_items=900, user_batch=256,
                                     min_len=3, mean_len=8.0, seed=1)],
                         ids=["defaults", "short-histories"])
def test_realistic_ratings_and_retrieval_dataset_are_bit_equal_to_jax(kw):
    frame = jax_realistic_ratings(**kw)
    cols = realistic_ratings(**kw)
    assert cols.keys() == set(frame.columns)
    for name, col in cols.items():
        assert col.dtype == frame[name].to_numpy().dtype, name
        np.testing.assert_array_equal(col, frame[name].to_numpy(), err_msg=name)
    for maxlen, min_count in ((5, 2), (50, 4)):
        want = jax_build(frame, maxlen=maxlen, min_item_count=min_count)
        got = build_seq_retrieval_dataset(cols, maxlen=maxlen, min_item_count=min_count)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_retrieval_dataset_on_synthetic_ratings_is_bit_equal_to_jax():
    # clustered ids with repeats: items seen once are dropped, users with
    # fewer than 3 kept events too
    frame = jax_synthetic_ratings(num_users=150, num_items=60, events_per_user=(1, 8), seed=4)
    cols = synthetic_ratings(num_users=150, num_items=60, events_per_user=(1, 8), seed=4)
    want = jax_build(frame, maxlen=6)
    got = build_seq_retrieval_dataset(cols, maxlen=6)
    assert got[0] == want[0] and len(got[2]["hist"]) < 150
    for g, w in zip(got[1:], want[1:]):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- embedding -----------------------------------------------------------------
def _schemas(num_items, with_profile):
    sparse = [("age", 7), ("city", 50)] if with_profile else []
    jax_schema = JaxSchema(sparse=[JaxSparse(n, v, EMBED) for n, v in sparse],
                           varlen=[JaxVarLen("hist_item", num_items, EMBED, max_len=MAXLEN)])
    schema = FeatureSchema(sparse=[SparseFeature(n, v, EMBED) for n, v in sparse],
                           varlen=[VarLenSparseFeature("hist_item", num_items, EMBED,
                                                       max_len=MAXLEN)])
    return jax_schema, schema


def _histories(rng, n, num_items):
    """Front-padded histories of 0..MAXLEN items (row 0 empty)."""
    lens = rng.integers(0, MAXLEN + 1, n)
    lens[0] = 0
    hist = rng.integers(1, num_items, (n, MAXLEN)).astype(np.int32)
    hist[np.arange(MAXLEN)[None, :] < MAXLEN - lens[:, None]] = 0
    return hist


@pytest.mark.parametrize("mode", ["sum", "mean", "sqrtn"])
def test_stacked_embedding_varlen_lookups_match_jax(mode):
    """One shared group table, so the history field sits at an offset, and
    the JAX table is row-packed."""
    jax_schema, schema = _schemas(300, True)
    jm = JaxStackedEmbedding(jax_schema, num_groups=1)
    rng = np.random.default_rng(0)
    hist = _histories(rng, 9, 300)
    mask = hist != 0
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 2), jnp.int32))["params"]
    tm = StackedEmbedding(schema, num_groups=1)
    tm.load_state_dict(_unpack_tables(_np_tree(params), schema, 1, ""))
    apply = lambda method, *a, **kw: jm.apply({"params": params}, *a, method=method, **kw)  # noqa: E731
    want = apply(jm.pooled_lookup, "hist_item", jnp.asarray(hist), jnp.asarray(mask), mode=mode)
    with torch.no_grad():
        got = tm.pooled_lookup("hist_item", torch.from_numpy(hist), torch.from_numpy(mask), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            tm.lookup("hist_item", torch.from_numpy(hist)).numpy(),
            np.asarray(apply(jm.lookup, "hist_item", jnp.asarray(hist))), **TOL)
        np.testing.assert_allclose(tm.table_logical("city").numpy(),
                                   np.asarray(apply(jm.table_logical, "city")), **TOL)
    assert tm.field_offset("hist_item") == 57 == apply(jm.field_offset, "hist_item")


def test_stacked_embedding_builds_with_varlen_fields_only():
    _, schema = _schemas(40, False)
    tm = StackedEmbedding(schema)
    assert tm.groups() == [] and tuple(tm.table(0).shape) == (40, EMBED)
    assert tuple(tm(torch.zeros((3, 0), dtype=torch.int32)).shape) == (3, 0, EMBED)


# -- the model -----------------------------------------------------------------
def _pair(num_items, with_profile=False, pooling="mean", hidden=(16, 8), seed=0):
    jax_schema, schema = _schemas(num_items, with_profile)
    jm = JaxYoutubeDNN(jax_schema, num_items=num_items, embed_dim=EMBED, hidden_units=hidden,
                       pooling=pooling)
    sample = {"hist": jnp.zeros((2, MAXLEN), jnp.int32), "item_id": jnp.ones((2,), jnp.int32)}
    if with_profile:
        sample["user_sparse"] = jnp.zeros((2, 2), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), sample)["params"]
    tm = YoutubeDNN(schema, num_items=num_items, embed_dim=EMBED, hidden_units=hidden,
                    pooling=pooling)
    tm.load_state_dict(youtube_dnn_params_from_jax(_np_tree(params), tm))
    return jm, params, tm.eval()


@pytest.mark.parametrize("with_profile, pooling", [(False, "mean"), (True, "mean"),
                                                   (True, "sqrtn"), (False, "sum")],
                         ids=["history", "profile", "profile-sqrtn", "history-sum"])
def test_youtube_dnn_embeddings_match_jax(with_profile, pooling):
    num_items = 300  # D = 32 at 300 rows: the JAX user table packs 4 rows to one
    jm, params, tm = _pair(num_items, with_profile, pooling)
    assert params["user_table"]["table_" + ("2" if with_profile else "0")].shape == (80, 128)
    rng = np.random.default_rng(1)
    batch = {"hist": _histories(rng, 12, num_items),
             "item_id": rng.integers(1, num_items, 12).astype(np.int32)}
    if with_profile:
        batch["user_sparse"] = np.stack([rng.integers(0, 7, 12), rng.integers(0, 50, 12)],
                                        1).astype(np.int32)
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
        items = tm.all_item_embeddings()
    for key in ("user", "item"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    np.testing.assert_allclose(
        items.numpy(), np.asarray(jm.apply({"params": params}, method=jm.all_item_embeddings)),
        **TOL)
    # unit vectors, except an empty history's without a profile (0 through
    # zero biases)
    norms = got["user"].norm(dim=-1).numpy()
    np.testing.assert_allclose(norms[(batch["hist"] != 0).any(1)], 1.0, rtol=1e-6)
    assert (norms[0] == 0.0) != with_profile


def test_mlp_dropout_draws_from_the_trainer_generator_and_is_off_in_eval():
    mlp = MLP(6, (32, 16), out_dim=4, dropout_rate=0.5)
    x = torch.ones(8, 6)
    drops = [m for m in mlp.modules() if isinstance(m, Dropout)]
    assert len(drops) == 2
    for m in drops:
        m.generator = torch.Generator().manual_seed(3)
    a = mlp.train()(x)
    for m in drops:
        m.generator = torch.Generator().manual_seed(3)
    assert torch.equal(mlp(x), a) and not torch.equal(mlp(x), a)
    assert torch.equal(mlp.eval()(x), mlp(x))
    _, schema = _schemas(40, False)
    tm = YoutubeDNN(schema, num_items=40, embed_dim=EMBED, hidden_units=(16,), dropout_rate=0.3)
    tr = Trainer(tm, loss_fn=_loss_fn(None), seed=2, device="cpu")
    assert {id(m.generator) for m in tm.modules() if isinstance(m, Dropout)} == {id(tr.generator)}


def _loss_fn(log_q):
    def loss(out, batch):
        lq = None if log_q is None else log_q[batch["item_id"].long()]
        return losses.in_batch_sampled_softmax(out["user"], out["item"], item_log_q=lq)
    return loss


def _jax_loss_fn(log_q):
    def loss(out, batch):
        return jax_losses.in_batch_sampled_softmax(out["user"], out["item"],
                                                   item_log_q=log_q[batch["item_id"]])
    return loss


def _dataset(maxlen=MAXLEN):
    return build_seq_retrieval_dataset(
        realistic_ratings(num_users=300, num_items=600, mean_len=8.0, seed=5), maxlen=maxlen)


STEPS, BATCH, LR = 3, 32, 1e-3


def _jax_trainer(jm, params, train, log_q, lr=LR):
    jt = JaxTrainer(jm, loss_fn=_jax_loss_fn(jnp.asarray(log_q.numpy())), learning_rate=lr)
    jt.init({k: v[:2] for k, v in train.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    return jt


def test_train_steps_match_jax():
    ni, train, _ = _dataset()
    assert ni > 256  # the JAX history table is row-packed
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni))
    jm, params, tm = _pair(ni)
    jt = _jax_trainer(jm, params, train, log_q)
    tt = Trainer(tm, loss_fn=_loss_fn(log_q), learning_rate=LR, device="cpu")
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in train.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL,
                                   err_msg=f"loss of step {s + 1}")
    # every Adam step moves a cell by about lr; a gradient within the two
    # frameworks' rounding noise of zero may move its cell the other way
    want = youtube_dnn_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert diff.max() <= 2 * LR * STEPS * 1.001, name
        assert (diff > 1e-5).float().mean() <= 1e-3, name
    # Adam moments within 1e-5 of each tensor's largest magnitude
    adam = jt.state.opt_state[0]
    named = dict(tm.named_parameters())
    for jtree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        for name, w in youtube_dnn_params_from_jax(_np_tree(jtree), tm).items():
            diff = (tt.optimizer.state[named[name]][key] - w).abs().max()
            assert diff <= 1e-5 * w.abs().max(), (name, key, float(diff))


def test_fit_then_recall_at_10_equals_jax():
    """``cli youtube``'s flow at a small size: the same batches in the same
    order through both Trainers, then each package's user tower and top-10
    over the whole catalog, and recall@10 on the held-out last items."""
    ni, train, test = _dataset()
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni))
    jm, params, tm = _pair(ni)
    jt = _jax_trainer(jm, params, train, log_q, lr=1e-2)
    tt = Trainer(tm, loss_fn=_loss_fn(log_q), learning_rate=1e-2, device="cpu")
    n_steps = len(train["item_id"]) // 64
    for s in range(n_steps):
        batch = {k: v[s * 64:(s + 1) * 64] for k, v in train.items()}
        jt.state, _, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tt.train_step(batch)
    variables = {"params": jt.state.params}
    u = jm.apply(variables, {"hist": jnp.asarray(test["hist"])}, method=jm.user_embed)
    _, want = jax_retrieval.topk_scores(u, jm.apply(variables, method=jm.all_item_embeddings),
                                        k=10)
    with torch.no_grad():
        _, got = topk_scores(tm.user_embed({"hist": torch.from_numpy(test["hist"])}),
                             tm.all_item_embeddings(), k=10)
    r_jax = jax_recall_at_k(np.asarray(want), test["item_id"])
    r = recall_at_k(got.numpy(), test["item_id"])
    assert n_steps >= 10 and r == r_jax > 10 / ni
    assert (got.numpy() == np.asarray(want)).mean() > 0.99


def test_predict_returns_user_and_item_embeddings():
    ni, _, test = _dataset()
    _, _, tm = _pair(ni)
    out = Trainer(tm, device="cpu").predict(test, batch_size=16)
    n = len(test["hist"])
    assert n % 16 and out["user"].shape == (n, EMBED) and out["item"].shape == (n, EMBED)
    with torch.no_grad():
        want = tm.user_embed({"hist": torch.from_numpy(test["hist"])})
    np.testing.assert_allclose(out["user"], want.numpy(), **TOL)


def test_trainer_refuses_ids_outside_their_tables():
    ni, train, test = _dataset()
    _, _, tm = _pair(ni)
    tr = Trainer(tm, loss_fn=_loss_fn(None), device="cpu")
    for key, bad_id in (("hist", ni), ("item_id", -1)):
        bad = dict(test, **{key: test[key].copy()})
        bad[key].flat[3] = bad_id
        with pytest.raises(ValueError, match=f"{key} ids"):
            tr.predict(bad, batch_size=16)
    _, _, tp = _pair(ni, with_profile=True)
    tr = Trainer(tp, loss_fn=_loss_fn(None), device="cpu")
    bad = dict(train, user_sparse=np.zeros((len(train["hist"]), 2), np.int32))
    bad["user_sparse"][5, 1] = 50  # city has 50 ids
    with pytest.raises(ValueError, match="sparse ids"):
        tr.fit(bad, batch_size=len(bad["hist"]), epochs=1, verbose=False)
