"""The port's two-tower models against the JAX package on the CPU:
``SEBlock``; ``TwoTower`` in score and pair mode, ``DSSM`` and ``SENetDSSM``
(with SENet's clip of the cosine at 0); ``FMMatch``'s logit, ``user_embed``
and ``item_embed``; each from weights converted with
``two_tower_params_from_jax`` / ``fm_match_params_from_jax``, with every
parameter's gradient; then three ``Trainer`` steps of DSSM (the
logQ-corrected in-batch softmax) and FM-match (BCE) against the JAX
``Trainer``.  Inputs come from numpy with a seed; the user tables are
row-packed on the JAX side.

Tolerances: f32 on both sides, sums in another order: 1e-5 on outputs
and losses; each parameter's gradient within 1e-5 of the norm of the whole
gradient (the towers' last bias takes a sum over the batch that cancels to
about 1e-6 of the whole, so its own norm is no scale); the parameters after
three steps within 1e-5 for FM-match; DSSM's softmax leaves some gradients at exactly
0, whose cells Adam moves by +-lr on rounding noise (the rule is stated
at ``test_dssm_train_steps_match_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.features import FeatureSchema as JaxSchema
from recsys_tpu.core.features import SparseFeature as JaxSparse
from recsys_tpu.models.match.fm_match import FMMatch as JaxFMMatch
from recsys_tpu.models.match.two_tower import TwoTower as JaxTwoTower
from recsys_tpu.models.match.two_tower import cosine as jax_cosine
from recsys_tpu.ops.interactions import SEBlock as JaxSEBlock
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import (_dense, fm_match_params_from_jax,
                                      two_tower_params_from_jax)
from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature
from recsys_tpu_torch.models.match.fm_match import FMMatch
from recsys_tpu_torch.models.match.two_tower import DSSM, SENetDSSM, TwoTower, cosine
from recsys_tpu_torch.ops.interactions import SEBlock
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
D = 8
USER_FIELDS = (("user_id", 300), ("age_bin", 9), ("gender", 3), ("occupation", 22))
ITEM_FIELDS = (("item_id", 400), ("cate", 21))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _schemas():
    return ((JaxSchema(sparse=[JaxSparse(n, v, D) for n, v in USER_FIELDS]),
             JaxSchema(sparse=[JaxSparse(n, v, D) for n, v in ITEM_FIELDS])),
            (FeatureSchema(sparse=[SparseFeature(n, v, D) for n, v in USER_FIELDS]),
             FeatureSchema(sparse=[SparseFeature(n, v, D) for n, v in ITEM_FIELDS])))


def _batch(rng, n):
    return {"user_sparse": np.stack([rng.integers(0, v, n) for _, v in USER_FIELDS],
                                    1).astype(np.int32),
            "item_sparse": np.stack([rng.integers(0, v, n) for _, v in ITEM_FIELDS],
                                    1).astype(np.int32),
            "label": (rng.random(n) < 0.4).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fields, reduction", [(4, 2), (2, 2), (5, 3), (1, 2)])
def test_se_block_matches_jax(fields, reduction):
    x = np.random.default_rng(fields).normal(size=(6, fields, D)).astype(np.float32)
    jm = JaxSEBlock(reduction)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm = SEBlock(fields, reduction)
    assert tm.dense0.out_features == max(1, fields // reduction)
    tm.load_state_dict({f"dense{j}.{k}": v for j in (0, 1)
                        for k, v in _dense(_np_tree(params)[f"Dense_{j}"]).items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               **TOL)


def test_cosine_matches_jax():
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=(2, 9, 5)).astype(np.float32)
    u[0] = 0.0
    np.testing.assert_allclose(cosine(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
                               np.asarray(jax_cosine(jnp.asarray(u), jnp.asarray(v))), **TOL)


def _two_tower(use_senet, output_mode, gamma=1.0, seed=0):
    (jus, jis), (us, its) = _schemas()
    kw = dict(user_units=(32, 16), item_units=(32, 16), out_dim=12, gamma=gamma,
              use_senet=use_senet, output_mode=output_mode)
    jm = JaxTwoTower(jus, jis, **kw)
    params = jm.init(jax.random.PRNGKey(seed), _jax(_batch(np.random.default_rng(0), 2)))[
        "params"]
    tm = TwoTower(us, its, **kw)
    tm.load_state_dict(two_tower_params_from_jax(_np_tree(params), tm))
    return jm, params, tm


def _fm_match(seed=0):
    (jus, jis), (us, its) = _schemas()
    jm = JaxFMMatch(jus, jis)
    params = jm.init(jax.random.PRNGKey(seed), _jax(_batch(np.random.default_rng(0), 2)))[
        "params"]
    # the first-order weights start at zero: give them values to compare
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.1)
        if "linear" in jax.tree_util.keystr(path) else a, params)
    tm = FMMatch(us, its)
    tm.load_state_dict(fm_match_params_from_jax(_np_tree(params), tm))
    return jm, params, tm


def _check_grads(jm, params, tm, loss_j, loss_t, batch, convert):
    jb = _jax(batch)
    jloss, jgrads = jax.value_and_grad(lambda p: loss_j(jm.apply({"params": p}, jb), jb))(
        params)
    tb = _torch(batch)
    tloss = loss_t(tm(tb), tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    want = convert(_np_tree(jgrads), tm)
    named = dict(tm.named_parameters())
    assert named.keys() == want.keys()
    whole = float(torch.cat([w.reshape(-1) for w in want.values()]).norm())
    for name, w in want.items():
        assert float((named[name].grad - w).norm()) <= 1e-5 * whole, name


def _bce(out, batch):
    return losses.bce_with_logits(out, batch["label"])


def _jax_bce(out, batch):
    return jax_losses.bce_with_logits(out, batch["label"])


@pytest.mark.parametrize("use_senet", [False, True], ids=["dssm", "senet"])
def test_two_tower_score_mode_matches_jax(use_senet):
    jm, params, tm = _two_tower(use_senet, "score", gamma=10.0)
    batch = _batch(np.random.default_rng(5), 24)
    want = np.asarray(jm.apply({"params": params}, _jax(batch)))
    with torch.no_grad():
        got = tm(_torch(batch)).numpy()
        for method in ("user_embed", "item_embed"):
            np.testing.assert_allclose(
                getattr(tm, method)(_torch(batch)).numpy(),
                np.asarray(jm.apply({"params": params}, _jax(batch),
                                    method=getattr(jm, method))), **TOL, err_msg=method)
    np.testing.assert_allclose(got, want, **TOL)
    # SENet clips negative cosines to 0; DSSM keeps them
    assert (got.min() >= 0.0) == use_senet and (got == 0.0).any() == use_senet
    _check_grads(jm, params, tm, _jax_bce, _bce, batch, two_tower_params_from_jax)


def _softmax(out, batch):
    return losses.in_batch_sampled_softmax(out["user"], out["item"])


def _jax_softmax(out, batch):
    return jax_losses.in_batch_sampled_softmax(out["user"], out["item"])


@pytest.mark.parametrize("maker, use_senet", [(DSSM, False), (SENetDSSM, True)],
                         ids=["dssm", "senet"])
def test_two_tower_pair_mode_matches_jax(maker, use_senet):
    jm, params, tm = _two_tower(use_senet, "pair")
    _, (us, its) = _schemas()
    made = maker(us, its, user_units=(32, 16), item_units=(32, 16), out_dim=12,
                 output_mode="pair")
    assert made.use_senet == use_senet and made.state_dict().keys() == tm.state_dict().keys()
    batch = _batch(np.random.default_rng(6), 24)
    want = jm.apply({"params": params}, _jax(batch))
    with torch.no_grad():
        got = tm(_torch(batch))
    assert got.keys() == want.keys() == {"user", "item"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    _check_grads(jm, params, tm, _jax_softmax, _softmax, batch, two_tower_params_from_jax)


def test_fm_match_logit_and_tower_embeddings_match_jax():
    jm, params, tm = _fm_match()
    batch = _batch(np.random.default_rng(7), 24)
    with torch.no_grad():
        np.testing.assert_allclose(tm(_torch(batch)).numpy(),
                                   np.asarray(jm.apply({"params": params}, _jax(batch))), **TOL)
        for method in ("user_embed", "item_embed"):
            np.testing.assert_allclose(
                getattr(tm, method)(_torch(batch)).numpy(),
                np.asarray(jm.apply({"params": params}, _jax(batch),
                                    method=getattr(jm, method))), **TOL, err_msg=method)
    _check_grads(jm, params, tm, _jax_bce, _bce, batch, fm_match_params_from_jax)


STEPS, BATCH, LR = 3, 32, 1e-3


def _steps(jm, params, tm, jloss, tloss, data, convert):
    """STEPS steps of both Trainers on the same batches, each loss within
    1e-5; returns (the JAX Trainer, the port's, the JAX params after each
    step, the port's, the JAX gradient of the first step)."""
    jt = JaxTrainer(jm, loss_fn=jloss, learning_rate=LR)
    jt.init({k: v[:2] for k, v in data.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    first = _jax(data)
    first = {k: v[:BATCH] for k, v in first.items()}
    grad1 = convert(_np_tree(jax.grad(lambda p: jloss(jm.apply({"params": p}, first), first))(
        params)), tm)
    tt = Trainer(tm, loss_fn=tloss, learning_rate=LR, device="cpu")
    jax_params, port_params = [], []
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
        jt.state, jl, _ = jt._train_step(jt.state, _jax(batch), jax.random.PRNGKey(s))
        np.testing.assert_allclose(tt.train_step(batch).item(), float(jl), **TOL,
                                   err_msg=f"loss of step {s + 1}")
        jax_params.append(convert(_np_tree(jt.state.params), tm))
        port_params.append({k: v.clone() for k, v in tm.state_dict().items()})
    return jt, tt, jax_params, port_params, grad1


def _step_data():
    data = _batch(np.random.default_rng(8), STEPS * BATCH)
    data["item_id"] = data["item_sparse"][:, 0].copy()
    return data


def test_fm_match_train_steps_match_jax():
    """BCE on rated pairs: every parameter within 1e-5 after each step."""
    jm, params, tm = _fm_match()
    _, _, want, got, _ = _steps(jm, params, tm, _jax_bce, _bce, _step_data(),
                                fm_match_params_from_jax)
    for s in range(STEPS):
        assert got[s].keys() == want[s].keys()
        for name, w in want[s].items():
            np.testing.assert_allclose(got[s][name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{name} after step {s + 1}")


def test_dssm_train_steps_match_jax():
    """The logQ-corrected in-batch softmax is unchanged when one vector is
    added to every item: the item tower's last bias, and each hidden bias
    whose unit is active for every item of the batch, have a gradient of
    exactly 0, which both frameworks compute as rounding noise and Adam's
    first step turns into +-lr either way.  So after the first step every
    cell is within 1e-5 but those (their gradient within 1e-5 of the
    largest), which are within 2·lr; after three steps, where the others
    follow them by a little, every cell is within 2·lr per step and at most
    1% of the model's cells beyond 1e-5; the losses within 1e-5 throughout."""
    jm, params, tm = _two_tower(False, "pair")
    data = _step_data()
    log_q = losses.popularity_log_q(np.bincount(data["item_id"], minlength=400))
    jlq = jnp.asarray(log_q.numpy())

    def jloss(out, batch):
        return jax_losses.in_batch_sampled_softmax(out["user"], out["item"],
                                                   item_log_q=jlq[batch["item_id"]])

    def tloss(out, batch):
        return losses.in_batch_sampled_softmax(out["user"], out["item"],
                                               item_log_q=log_q[batch["item_id"].long()])

    _, _, want, got, grad1 = _steps(jm, params, tm, jloss, tloss, data,
                                    two_tower_params_from_jax)
    top = max(float(g.abs().max()) for g in grad1.values())
    zero_grad = 0
    for name, w in want[0].items():
        diff = (got[0][name] - w).abs()
        still = grad1[name].abs() <= 1e-5 * top
        zero_grad += int(still.sum())
        assert (diff[~still] <= 1e-5).all(), name
        assert (diff[still] <= 2 * LR * 1.001).all(), name
    assert zero_grad >= tm.item_mlp.layers[-1].bias.numel()
    off = 0
    for name, w in want[-1].items():
        diff = (got[-1][name] - w).abs()
        assert diff.max() <= 2 * LR * STEPS * 1.001, name
        off += int((diff > 1e-5).sum())
    assert off <= 1e-2 * sum(w.numel() for w in want[-1].values()), off


def test_trainer_refuses_ids_outside_either_towers_vocabularies():
    _, _, tm = _fm_match()
    tr = Trainer(tm, device="cpu")
    data = _batch(np.random.default_rng(9), 40)
    for key, col, bad in (("user_sparse", 2, 3), ("item_sparse", 1, -1)):
        broken = dict(data, **{key: data[key].copy()})
        broken[key][7, col] = bad
        with pytest.raises(ValueError, match="sparse ids"):
            tr.predict(broken, batch_size=16)
