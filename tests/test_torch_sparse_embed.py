"""The touched-rows embedding optimizers ``lazy_adam`` and ``rowwise_adagrad``
(``recsys_tpu_torch/train/sparse_embed.py``) against
``recsys_tpu.train.sparse_embed`` on the same numpy inputs: three steps
with duplicate ids, a touched row whose summed gradient is exactly 0 and
weight decay, within 1e-6; the rows no batch touches, and their state,
bit-equal to where they started; and a small DLRM ``Trainer`` with each
kind for three steps against the JAX Trainer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.train import sparse_embed as jax_sparse
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import embedding_state_from_jax, params_from_jax
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.train import sparse_embed
from recsys_tpu_torch.train.loop import Trainer
from test_torch_dlrm import build_pair

V, D, N, STEPS, LR = 50, 8, 40, 3, 1e-2
TOL = dict(rtol=1e-6, atol=1e-6)


def _batches(seed):
    """STEPS (rows, cot): ids drawn from [0, 30) (rows 30.. stay untouched)
    with duplicates; row 7 occurs in every batch with cotangents that sum
    to exactly 0."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        rows = rng.integers(0, 30, N).astype(np.int32)
        rows[:3] = [5, 5, 5]
        rows[3:5] = 7
        cot = rng.standard_normal((N, D)).astype(np.float32)
        cot[rows == 7] = 0.0
        x = rng.standard_normal(D).astype(np.float32)
        cot[3], cot[4] = x, -x
        out.append((rows, cot))
    return out


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["lazy_adam", "rowwise_adagrad"])
def test_sparse_update_matches_jax(kind, wd):
    rng = np.random.default_rng(1)
    table0 = rng.standard_normal((V, D)).astype(np.float32)
    m0 = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    v0 = (rng.random((V, D)) * 0.01).astype(np.float32)
    acc0 = (rng.random(V) * 0.1).astype(np.float32)
    table, m, v, acc = (torch.from_numpy(a.copy()) for a in (table0, m0, v0, acc0))
    jt, jm, jv, jacc = jnp.asarray(table0), jnp.asarray(m0), jnp.asarray(v0), \
        jnp.asarray(acc0[:, None])
    batches = _batches(2)
    assert np.all(batches[0][1][3] + batches[0][1][4] == 0.0)
    for step, (rows, cot) in enumerate(batches, start=1):
        one = jnp.ones((N, 1), jnp.float32)
        if kind == "lazy_adam":
            jt, jm, jv = jax_sparse.lazy_adam_update(
                jt, jm, jv, jnp.asarray(rows), jnp.asarray(cot), one, lr=LR,
                step=jnp.asarray(step, jnp.int32), weight_decay=wd)
            sparse_embed.lazy_adam_update(table, m, v, torch.from_numpy(rows).long(),
                                          torch.from_numpy(cot), lr=LR, step=step,
                                          weight_decay=wd)
        else:
            jt, jacc = jax_sparse.rowwise_adagrad_update(
                jt, jacc, jnp.asarray(rows), jnp.asarray(cot), one, lr=LR, weight_decay=wd)
            sparse_embed.rowwise_adagrad_update(table, acc, torch.from_numpy(rows).long(),
                                                torch.from_numpy(cot), lr=LR, weight_decay=wd)
    np.testing.assert_allclose(table.numpy(), np.asarray(jt), **TOL)
    touched = np.unique(np.concatenate([r for r, _ in batches]))
    untouched = np.setdiff1d(np.arange(V), touched)
    assert 7 in touched and len(untouched) >= V - 30
    np.testing.assert_array_equal(table.numpy()[untouched], table0[untouched])
    if kind == "lazy_adam":
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
        np.testing.assert_array_equal(m.numpy()[untouched], m0[untouched])
        np.testing.assert_array_equal(v.numpy()[untouched], v0[untouched])
        # the zero-gradient row is touched: its moments decay
        assert np.all(np.abs(m.numpy()[7]) < np.abs(m0[7]))
    else:
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, 0], **TOL)
        np.testing.assert_array_equal(acc.numpy()[untouched], acc0[untouched])
        assert acc.numpy()[7] == acc0[7]
    if wd:  # lazy weight decay moves the zero-gradient row too
        assert not np.array_equal(table.numpy()[7], table0[7])


def test_bias_correction_uses_the_tables_dtype():
    """One Adam step at t = 1 of an f32 table from zero moments: the bias
    correction 1 - b1**t is computed in f32 (1 - 0.9f), as the JAX package
    casts the step to the table's dtype, not in Python's float64."""
    table, m, v = torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(4, 2)
    g = np.asarray([[0.5, -0.25]], np.float32)
    sparse_embed.lazy_adam_update(table, m, v, torch.tensor([1]), torch.from_numpy(g),
                                  lr=0.1, step=1)
    f = np.float32
    mu, vu = f(1.0 - 0.9) * g, f(1.0 - 0.999) * (g * g)
    m_hat, v_hat = mu / (f(1) - f(0.9) ** f(1)), vu / (f(1) - f(0.999) ** f(1))
    want = -f(0.1) * m_hat / (np.sqrt(v_hat) + f(1e-8))
    np.testing.assert_array_equal(table[1:2].numpy(), want)
    assert table[[0, 2, 3]].abs().sum() == 0
    wide = -f(0.1) * (mu / f(1 - 0.9 ** 1)) / (np.sqrt(vu / f(1 - 0.999 ** 1)) + f(1e-8))
    assert not np.array_equal(want, wide)


def test_apply_updates_refuses_an_unknown_kind():
    schema, _ = synthetic_ctr(num_examples=8, num_dense=2, num_sparse=4, vocab_size=10,
                              embed_dim=8)
    plan = sparse_embed.build_plan(DLRM(schema, sparse_embed_grads=True,
                                        device="cpu").embedding)
    with pytest.raises(ValueError, match="unknown"):
        sparse_embed.apply_updates({}, {}, plan, torch.zeros(2, 4, dtype=torch.int32),
                                   torch.zeros(2, 4, 8), kind="sgd", lr=0.1, step=1)


BATCH = 32


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["lazy_adam", "rowwise_adagrad"])
def test_dlrm_trainer_steps_match_jax(kind, wd):
    """Three train steps of a small DLRM (f32, tables of 1000 rows the JAX
    package packs 8 to a row) from the same weights on the same batches:
    the loss, the tables and their optimizer state within 1e-5; the dense
    parameters within 1e-5 but where Adam moves a near-zero gradient by
    its sign (as tests/test_torch_training.py allows)."""
    jm, params, tm, data = build_pair(num_examples=STEPS * BATCH, sparse_embed_grads=True)
    jt = JaxTrainer(jm, learning_rate=1e-3, embedding_optimizer=kind, weight_decay=wd,
                    embedding_lr=LR)
    jt.init({k: v[:8] for k, v in data.items()})
    jt.state = jt.state.replace(params=params)
    jt._build_steps()
    tt = Trainer(tm, learning_rate=1e-3, embedding_optimizer=kind, weight_decay=wd,
                 embedding_lr=LR, device="cpu")
    assert tt._prep is None
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), tm.schema, tm)
    got = tt.model.state_dict()
    for name, w in want.items():
        if "table" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            diff = np.abs(got[name].double().numpy() - w.double().numpy())
            assert diff.max() <= 2 * 1e-3 * STEPS * 1.001 and (diff > 1e-5).mean() <= 1e-3, name
    jstate = embedding_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.opt_state["emb"]), tm.schema, tm)
    assert jstate.keys() == tt.emb_state.keys()
    for name, st in jstate.items():
        for k, w in st.items():
            np.testing.assert_allclose(tt.emb_state[name][k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{name}.{k}")
