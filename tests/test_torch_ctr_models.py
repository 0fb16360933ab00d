"""The port's CTR protocol slice against the JAX package on the CPU: the
interaction ops, the six CTR models (FM, DeepFM, Wide&Deep, DeepCrossing,
DCN, AutoInt) from weights converted from a JAX init, their train steps
against the JAX Trainer, ``realistic_criteo`` (bit-equal), early stopping
with best-weight restore, and the ``protocol ctr`` runner's report.  Small
schemas (4-5 fields, D = 8, vocabularies up to 1000), inputs from numpy with
a seed.

Tolerances: f32 on both sides, sums in another order: 1e-5 on outputs and
losses; parameters and Adam moments after the steps as
tests/test_torch_youtube.py."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data.realistic import _auc as jax_auc
from recsys_tpu.data.realistic import realistic_criteo as jax_realistic_criteo
from recsys_tpu.data.synthetic import synthetic_ctr as jax_synthetic_ctr
from recsys_tpu.models.ctr.autoint import AutoInt as JaxAutoInt
from recsys_tpu.models.ctr.dcn import DCN as JaxDCN
from recsys_tpu.models.ctr.deep_crossing import DeepCrossing as JaxDeepCrossing
from recsys_tpu.models.ctr.deepfm import DeepFM as JaxDeepFM
from recsys_tpu.models.ctr.fm import FM as JaxFM
from recsys_tpu.models.ctr.wide_deep import WideDeep as JaxWideDeep
from recsys_tpu.ops import interactions as jax_ops
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import ctr_params_from_jax, embedding_state_from_jax
from recsys_tpu_torch.data.realistic import CRITEO_VOCABS, _auc, realistic_criteo
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.models.ctr.fm import FM
from recsys_tpu_torch.ops.interactions import (CrossNetwork, DotInteraction, LinearLogit,
                                               ResidualUnit)
from recsys_tpu_torch.tools import protocol
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
EMBED = 8
JAX_MODELS = {"fm": JaxFM, "deepfm": JaxDeepFM, "widedeep": JaxWideDeep,
              "deepcrossing": JaxDeepCrossing, "dcn": JaxDCN, "autoint": JaxAutoInt}
# narrow towers; AutoInt keeps its 3 layers of 2 heads (head width 4)
OPTIONS = {"fm": {}, "deepfm": dict(hidden_units=(32, 16)),
           "widedeep": dict(hidden_units=(32, 16)), "deepcrossing": dict(hidden_units=(24, 24)),
           "dcn": dict(hidden_units=(32, 16)), "autoint": {}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- ops -----------------------------------------------------------------------
def _jax_init_apply(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(  # zero-initialised leaves made nonzero
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32), params)
    return params, np.asarray(module.apply({"params": params}, jnp.asarray(x)))


def test_cross_network_residual_unit_and_linear_logit_match_jax():
    x = np.random.default_rng(1).standard_normal((16, 12)).astype(np.float32)
    params, want = _jax_init_apply(jax_ops.CrossNetwork(num_layers=3), x)
    cross = CrossNetwork(12, 3)
    cross.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    params, want_res = _jax_init_apply(jax_ops.ResidualUnit(20), x)
    res = ResidualUnit(12, 20)
    res.load_state_dict({f"dense{j}.{k}": v for j in (0, 1) for k, v in (
        ("weight", torch.from_numpy(params[f"Dense_{j}"]["kernel"].T.copy())),
        ("bias", torch.from_numpy(params[f"Dense_{j}"]["bias"])))})
    params, want_lin = _jax_init_apply(jax_ops.LinearLogit(), x)
    lin = LinearLogit(12)
    lin.load_state_dict({"dense.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
                         "dense.bias": torch.from_numpy(params["Dense_0"]["bias"])})
    with torch.no_grad():
        tx = torch.from_numpy(x)
        for got, w in ((cross(tx), want), (res(tx), want_res), (lin(tx), want_lin)):
            np.testing.assert_allclose(got.numpy(), w, **TOL)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_module_matches_jax(self_interaction):
    x = np.random.default_rng(2).standard_normal((6, 5, EMBED)).astype(np.float32)
    want = jax_ops.DotInteraction(self_interaction=self_interaction).apply(
        {}, jnp.asarray(x))
    got = DotInteraction(self_interaction)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the models ----------------------------------------------------------------
def _data(num_dense, n=128, seed=0):
    kw = dict(num_examples=n, num_dense=num_dense, num_sparse=5, vocab_size=1000,
              embed_dim=EMBED, seed=seed)
    jschema, data = jax_synthetic_ctr(**kw)
    schema, data_t = synthetic_ctr(**kw)
    for k in data:
        np.testing.assert_array_equal(data[k], data_t[k])
    return jschema, schema, data


def _pair(name, jschema, schema, data, seed=0, **extra):
    """(JAX model, its params as a numpy tree, port model loaded with them):
    a JAX init with noise added to every leaf, so the zero-initialised
    first-order weights and biases count too."""
    jm = JAX_MODELS[name](jschema, **OPTIONS[name], **extra)
    sample = {k: jnp.asarray(v[:8]) for k, v in data.items() if k != "label"}
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), sample)["params"])
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.01, a.shape).astype(np.float32), params)
    tm = protocol.CTR_MODELS[name](schema, **OPTIONS[name], **extra)
    tm.load_state_dict(ctr_params_from_jax(params, tm))
    return jm, params, tm


@pytest.mark.parametrize("num_dense", [4, 0], ids=["dense", "no-dense"])
@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_ctr_model_logits_match_jax(name, num_dense):
    jschema, schema, data = _data(num_dense)
    jm, params, tm = _pair(name, jschema, schema, data)
    batch = {k: v[:48] for k, v in data.items()}
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (48,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_converter_refuses_params_it_does_not_know():
    jschema, schema, data = _data(4)
    _, params, tm = _pair("fm", jschema, schema, data)
    with pytest.raises(ValueError, match="SEBlock_0"):
        ctr_params_from_jax(dict(params, SEBlock_0={}), tm)


STEPS_OF = {"fm": 3, "deepfm": 3, "widedeep": 1, "deepcrossing": 1, "dcn": 1, "autoint": 1}
BATCH, LR = 32, 1e-3


def _close_after(name, got, want, steps):
    """Every Adam step moves a cell by about lr; a gradient within the two
    frameworks' rounding noise of zero may move its cell the other way."""
    diff = (got - want).abs()
    assert diff.max() <= 2 * LR * steps * 1.001, name
    assert (diff > 1e-5).float().mean() <= 1e-3, name


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_train_steps_match_jax(name):
    steps = STEPS_OF[name]
    jschema, schema, data = _data(4, n=steps * BATCH)
    jm, params, tm = _pair(name, jschema, schema, data)
    jt = JaxTrainer(jm, learning_rate=LR)
    jt.init({k: v[:8] for k, v in data.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state = jt.state.replace(params=jparams, opt_state=jt.tx.init(jparams))
    jt._build_steps()
    tt = Trainer(tm, learning_rate=LR, device="cpu")
    for s in range(steps):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL,
                                   err_msg=f"loss of step {s + 1}")
    want = ctr_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        _close_after(key, got[key], w, steps)
    # Adam moments within 1e-5 of each tensor's largest magnitude
    adam = jt.state.opt_state[0]
    named = dict(tm.named_parameters())
    for jtree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        for pname, w in ctr_params_from_jax(_np_tree(jtree), tm).items():
            diff = (tt.optimizer.state[named[pname]][key] - w).abs().max()
            assert diff <= 1e-5 * w.abs().max(), (pname, key, float(diff))


def test_fm_step_with_the_fused_adam_table_update_matches_jax():
    jschema, schema, data = _data(4, n=BATCH)
    jm, params, tm = _pair("fm", jschema, schema, data, sparse_embed_grads=True)
    jt = JaxTrainer(jm, learning_rate=LR, embedding_optimizer="fused_adam",
                    embedding_fused_bf16=False)
    jt.init({k: v[:8] for k, v in data.items()})
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jt._build_steps()
    tt = Trainer(tm, learning_rate=LR, embedding_optimizer="fused_adam",
                 embedding_fused_bf16=False, device="cpu")
    jb = dict(data, **jt._streaming_prep(data["sparse"]))
    jt.state, jloss, _ = jt._train_step(jt.state, {k: jnp.asarray(v) for k, v in jb.items()},
                                        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(tt.train_step(data)), float(jloss), **TOL)
    want = ctr_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    for key, w in want.items():
        _close_after(key, got[key], w, 1)
    jstate = embedding_state_from_jax(_np_tree(jt.state.opt_state["emb"]), schema, tm)
    assert jstate.keys() == tt.emb_state.keys()
    for g, st in jstate.items():
        for k, w in st.items():
            np.testing.assert_allclose(tt.emb_state[g][k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-9, err_msg=f"{g}.{k}")


# -- data ----------------------------------------------------------------------
@pytest.mark.parametrize("teacher", ["fm", "mlp"])
def test_realistic_criteo_is_bit_equal_to_jax(teacher):
    jschema, jdata, jmeta = jax_realistic_criteo(num_examples=3000, seed=4, teacher=teacher)
    schema, data, meta = realistic_criteo(num_examples=3000, seed=4, teacher=teacher)
    assert [(f.name, f.vocab_size, f.embed_dim) for f in schema.sparse] == \
        [(f.name, f.vocab_size, f.embed_dim) for f in jschema.sparse]
    assert [f.name for f in schema.dense] == [f.name for f in jschema.dense]
    assert tuple(f.vocab_size for f in schema.sparse) == CRITEO_VOCABS
    assert data.keys() == jdata.keys()
    for k in data:
        assert data[k].dtype == jdata[k].dtype, k
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
    np.testing.assert_array_equal(meta["p_true"], jmeta["p_true"])
    assert meta["ctr"] == jmeta["ctr"] and meta["oracle_auc"] == jmeta["oracle_auc"]
    assert 0.7 < meta["oracle_auc"] < 0.95


def test_exact_auc_equals_jax_with_ties():
    rng = np.random.default_rng(6)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    scores = np.round(rng.random(500) + 0.5 * labels, 2)  # many ties
    assert _auc(labels, scores) == jax_auc(labels, scores)
    assert _auc(np.zeros(5), scores[:5]) == 0.5


# -- early stopping ------------------------------------------------------------
@pytest.mark.parametrize("patience", [2, None])
def test_fit_stops_early_and_restores_the_best_weights(patience):
    """At lr 0.3 the validation loss bottoms out within a few epochs and
    then rises: fit stops ``patience`` epochs after the best one and loads
    it back (without early stopping it runs every epoch and loads it back
    too); the optimizer's steps are not undone."""
    schema, data = synthetic_ctr(num_examples=600, num_dense=3, num_sparse=4,
                                 vocab_size=50, embed_dim=EMBED, seed=5)
    torch.manual_seed(0)
    tr = Trainer(FM(schema), learning_rate=0.3, seed=1, device="cpu")
    epochs = 30 if patience else 8
    hist = tr.fit(data, batch_size=64, epochs=epochs, validation_split=0.2,
                  early_stopping_patience=patience, verbose=False)
    val = hist["val_loss"]
    best = int(np.argmin(val))
    ran = len(hist["loss"])
    assert ran == (best + 1 + patience if patience else epochs) and ran < 30
    assert val[-1] > val[best] + 1e-3  # the last weights are not the best
    assert tr.step == ran * (480 // 64)
    got = tr.evaluate_loss({k: v[480:] for k, v in data.items()}, batch_size=64)
    np.testing.assert_allclose(got, min(val), rtol=1e-6)


# -- the runner ----------------------------------------------------------------
def test_protocol_ctr_report_has_the_jax_reports_keys(tmp_path):
    out = tmp_path / "report.json"
    protocol.main(["ctr", "--rows", "3000", "--epochs", "2", "--device", "cpu",
                   "--out", str(out)])
    rep = json.loads(out.read_text())
    jax_rep = json.loads((Path(__file__).resolve().parents[1] / "artifacts" /
                          "protocol_ctr_fm_s0.json").read_text())
    assert rep.keys() == jax_rep.keys()
    assert list(rep["models"]) == list(jax_rep["models"])
    for name, m in rep["models"].items():
        assert m.keys() == jax_rep["models"][name].keys() | {"fit_examples_per_s"}
        assert 0.0 <= m["test_auc"] <= 1.0 and 1 <= m["epochs_ran"] <= 2
        assert m["fit_examples_per_s"] > 0
    _, _, jmeta = jax_realistic_criteo(num_examples=3000, seed=0)
    assert rep["oracle_auc"] == round(jmeta["oracle_auc"], 4) and rep["rows"] == 3000
