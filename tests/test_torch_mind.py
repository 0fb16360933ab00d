"""The port's MIND against the JAX package on the CPU: ``squash``, the
routing's starting logits against ``jax.random.normal(PRNGKey(0), (1, K,
L))``, ``CapsuleRouting`` on padded histories (one of them all pads),
``LabelAwareAttention``, ``MIND.interests`` and the forward from weights
converted with ``mind_params_from_jax``, every parameter's gradient of the
logQ-corrected in-batch softmax, three ``Trainer`` steps against the JAX
``Trainer``, and the protocol's merge of the capsules' top-10 lists against
the JAX runner's loop.  Inputs come from numpy with a seed.

Tolerances: f32 on both sides, sums in another order: 1e-5 on outputs and
losses; gradients within 1e-5 of their norm; the starting logits within
2e-5 (scipy's float64 erfinv against XLA's float32 polynomial)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.models.match.mind import MIND as JaxMIND
from recsys_tpu.models.match.mind import CapsuleRouting as JaxRouting
from recsys_tpu.models.match.mind import LabelAwareAttention as JaxAttention
from recsys_tpu.models.match.mind import squash as jax_squash
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import mind_params_from_jax
from recsys_tpu_torch.data.movielens import build_seq_retrieval_dataset
from recsys_tpu_torch.data.realistic import realistic_ratings
from recsys_tpu_torch.models.match.mind import (MIND, CapsuleRouting, LabelAwareAttention,
                                                routing_logits, squash)
from recsys_tpu_torch.tools.protocol import merge_capsule_topk
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
D, K, L, UNITS = 16, 4, 8, (16,)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _histories(rng, n, num_items, length=L):
    """Front-padded histories of 0..length items; row 0 all pads."""
    lens = rng.integers(0, length + 1, n)
    lens[0] = 0
    hist = rng.integers(1, num_items, (n, length)).astype(np.int32)
    hist[np.arange(length)[None, :] < length - lens[:, None]] = 0
    return hist


def test_squash_matches_jax():
    s = np.random.default_rng(0).normal(size=(5, 3, 7)).astype(np.float32)
    s[0, 0] = 0.0
    for axis in (-1, 1):
        np.testing.assert_allclose(squash(torch.from_numpy(s), dim=axis).numpy(),
                                   np.asarray(jax_squash(jnp.asarray(s), axis=axis)), **TOL)


@pytest.mark.parametrize("k, length", [(4, 50), (4, 20), (2, 7), (8, 200)])
def test_routing_logits_match_jax_random_normal(k, length):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, k, length)))
    got = routing_logits(k, length)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # draws for fewer capsules are a prefix; for another length they are not
    np.testing.assert_array_equal(routing_logits(1, length)[0, 0], got[0, 0])


@pytest.mark.parametrize("iterations", [1, 3])
def test_capsule_routing_matches_jax_on_padded_histories(iterations):
    rng = np.random.default_rng(1)
    hist = rng.normal(size=(6, L, D)).astype(np.float32)
    mask = _histories(rng, 6, 50) != 0  # row 0 all pads
    jm = JaxRouting(K, iterations)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(hist), jnp.asarray(mask))["params"]
    tm = CapsuleRouting(D, K, iterations)
    tm.load_state_dict({"S": torch.tensor(np.asarray(params["S"]))})
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(hist), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(hist), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # a padded behaviour weighs 1/K in every capsule: the all-pad row's
    # capsules are equal
    np.testing.assert_allclose(got[0], np.broadcast_to(got[0, :1], got[0].shape), **TOL)


def test_label_aware_attention_matches_jax():
    rng = np.random.default_rng(2)
    caps = rng.normal(size=(7, K, D)).astype(np.float32)
    item = rng.normal(size=(7, D)).astype(np.float32)
    for p in (1.0, 2.0):
        want = JaxAttention(p).apply({}, jnp.asarray(caps), jnp.asarray(item))
        with torch.no_grad():
            got = LabelAwareAttention(p)(torch.from_numpy(caps), torch.from_numpy(item))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pair(num_items, seed=0):
    jm = JaxMIND(num_items=num_items, embed_dim=D, k_max=K, user_units=UNITS)
    sample = {"hist": jnp.zeros((2, L), jnp.int32), "item_id": jnp.ones((2,), jnp.int32)}
    params = jm.init(jax.random.PRNGKey(seed), sample)["params"]
    tm = MIND(num_items=num_items, embed_dim=D, k_max=K, user_units=UNITS)
    tm.load_state_dict(mind_params_from_jax(_np_tree(params), tm))
    return jm, params, tm.eval()


def _batch(rng, n, num_items):
    return {"hist": _histories(rng, n, num_items),
            "item_id": rng.integers(1, num_items, n).astype(np.int32)}


def test_mind_interests_and_forward_match_jax():
    jm, params, tm = _pair(60)
    batch = _batch(np.random.default_rng(3), 9, 60)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply({"params": params}, jb)
    with torch.no_grad():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got = tm(tb)
        np.testing.assert_allclose(
            tm.interests(tb).numpy(),
            np.asarray(jm.apply({"params": params}, jb, method=jm.interests)), **TOL)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    np.testing.assert_array_equal(tm.all_item_embeddings().detach().numpy(),
                                  np.asarray(params["item_table"]))


def _loss_fn(log_q):
    def loss(out, batch):
        return losses.in_batch_sampled_softmax(out["user"], out["item"],
                                               item_log_q=log_q[batch["item_id"].long()])
    return loss


def _jax_loss_fn(log_q):
    def loss(out, batch):
        return jax_losses.in_batch_sampled_softmax(out["user"], out["item"],
                                                   item_log_q=log_q[batch["item_id"]])
    return loss


def test_gradients_of_the_logq_softmax_match_jax():
    num_items = 60
    jm, params, tm = _pair(num_items)
    rng = np.random.default_rng(4)
    batch = _batch(rng, 16, num_items)
    log_q = losses.popularity_log_q(rng.integers(0, 20, num_items))
    jl = _jax_loss_fn(jnp.asarray(log_q.numpy()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jl(jm.apply({"params": p}, jb), jb))(params)
    tm.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = _loss_fn(log_q)(tm(tb), tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    want = mind_params_from_jax(_np_tree(jgrads), tm)
    named = dict(tm.named_parameters())
    assert named.keys() == want.keys()
    for name, w in want.items():
        g = named[name].grad
        assert float((g - w).norm()) <= 1e-5 * float(w.norm()), name
    assert float(named["routing.S"].grad.norm()) > 0  # the routing trains


def _dataset():
    return build_seq_retrieval_dataset(
        realistic_ratings(num_users=300, num_items=400, mean_len=8.0, seed=6), maxlen=L)


STEPS, BATCH, LR = 3, 32, 1e-3


def test_train_steps_match_jax():
    ni, train, _ = _dataset()
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni))
    jm, params, tm = _pair(ni)
    jt = JaxTrainer(jm, loss_fn=_jax_loss_fn(jnp.asarray(log_q.numpy())), learning_rate=LR)
    jt.init({k: v[:2] for k, v in train.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    tt = Trainer(tm, loss_fn=_loss_fn(log_q), learning_rate=LR, device="cpu")
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in train.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL,
                                   err_msg=f"loss of step {s + 1}")
    want = mind_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def _jax_merge(v, ids, k):
    """The JAX runner's merge (``recsys_tpu/tools/protocol.py`` run_mind),
    line by line."""
    b = v.shape[0]
    merged = np.empty((b, k), np.int64)
    order = np.argsort(-v, axis=1, kind="mergesort")
    for r in range(b):
        seen, out_row = set(), []
        for c in order[r]:
            it = int(ids[r, c])
            if it not in seen:
                seen.add(it)
                out_row.append(it)
                if len(out_row) == k:
                    break
        merged[r] = out_row + [-1] * (k - len(out_row))
    return merged


@pytest.mark.parametrize("distinct", [5, 12, 400])
def test_capsule_merge_equals_the_jax_loop(distinct):
    """Duplicates across capsules, equal values (the stable sort keeps the
    capsule order) and users with fewer than k distinct items (-1 fill)."""
    rng = np.random.default_rng(distinct)
    b, km, k = 64, 4, 10
    ids = rng.integers(0, distinct, (b, km * k)).astype(np.int32)
    v = np.round(rng.normal(size=(b, km * k)), 1).astype(np.float32)
    got = merge_capsule_topk(v, ids, k)
    want = _jax_merge(v, ids, k)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if distinct < k:
        assert (got == -1).any(1).all()
