"""The port's multi-task slice against the JAX package on the CPU:
``ExpertBank`` (its init law included), ``SoftmaxGate``, ``mix``,
``bce_probs`` and ``multi_task_bce``; ESMM, MMoE and PLE (two levels, and
three) from weights converted with ``esmm_params_from_jax`` /
``mmoe_params_from_jax`` / ``ple_params_from_jax``, forward and three
``Trainer`` steps against the JAX ``Trainer``; ``realistic_multitask`` and
``synthetic_multitask`` bit-equal; and the census pipeline:
``realistic_census`` written to CSV files and read back by each package's
loader gives the same codes, dense values, labels and splits, and so does
a hand-written file whose categorical columns hold integers, floats and
text.

Tolerances: f32 on both sides, sums in another order: 1e-5 on outputs,
losses and parameters; the data bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data import census as jax_census
from recsys_tpu.data.realistic import realistic_census as jax_realistic_census
from recsys_tpu.data.realistic import realistic_multitask as jax_realistic_multitask
from recsys_tpu.data.synthetic import synthetic_multitask as jax_synthetic_multitask
from recsys_tpu.models.ctr.esmm import ESMM as JaxESMM
from recsys_tpu.models.ctr.mmoe import MMoE as JaxMMoE
from recsys_tpu.models.ctr.ple import PLE as JaxPLE
from recsys_tpu.ops.experts import ExpertBank as JaxExpertBank
from recsys_tpu.ops.experts import SoftmaxGate as JaxSoftmaxGate
from recsys_tpu.ops.experts import mix as jax_mix
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import (_dense, esmm_params_from_jax, mmoe_params_from_jax,
                                      ple_params_from_jax)
from recsys_tpu_torch.data import census
from recsys_tpu_torch.data.realistic import realistic_census, realistic_multitask
from recsys_tpu_torch.data.synthetic import synthetic_multitask
from recsys_tpu_torch.models.ctr.esmm import ESMM
from recsys_tpu_torch.models.ctr.mmoe import MMoE
from recsys_tpu_torch.models.ctr.ple import PLE
from recsys_tpu_torch.ops.experts import ExpertBank, SoftmaxGate, mix
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_expert_bank_gate_and_mix_match_jax():
    x = np.random.default_rng(0).normal(size=(9, 12)).astype(np.float32)
    bank = JaxExpertBank(5, (16, 8))
    bp = bank.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    gate = JaxSoftmaxGate(5)
    gp = gate.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tb, tg = ExpertBank(5, 12, (16, 8)), SoftmaxGate(12, 5)
    tb.load_state_dict({k: _t(v) for k, v in bp.items()})
    tg.load_state_dict({"dense.weight": _dense(_np_tree(gp["Dense_0"]))["weight"]})
    je = bank.apply({"params": bp}, jnp.asarray(x))
    jw = gate.apply({"params": gp}, jnp.asarray(x))
    with torch.no_grad():
        te, tw = tb(torch.from_numpy(x)), tg(torch.from_numpy(x))
        assert te.shape == (9, 5, 8) and tw.shape == (9, 5)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(mix(te, tw).numpy(), np.asarray(jax_mix(je, jw)), **TOL)


def test_expert_bank_init_draws_lecun_normal_per_expert():
    """flax's ``lecun_normal(batch_axis=(0,))``: each expert's (in, out)
    kernel a normal of sd 1/sqrt(in), truncated at 2 sd and rescaled; a
    fresh port bank and a fresh JAX bank agree in range and moments."""
    torch.manual_seed(0)
    tb = ExpertBank(8, 256, (64,))
    jp = JaxExpertBank(8, (64,)).init(jax.random.PRNGKey(0), jnp.zeros((2, 256)))["params"]
    got, want = tb.w0.detach().numpy().ravel(), np.asarray(jp["w0"]).ravel()
    edge = 2.0 / np.sqrt(256) / 0.87962566103423978
    for draws in (got, want):
        assert np.abs(draws).max() <= edge * (1 + 1e-6)
    assert abs(got.std() - want.std()) < 0.02 * want.std()
    assert not tb.b0.detach().any()


def test_bce_probs_and_multi_task_bce_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 1, 50).astype(np.float32)
    p[:3] = (0.0, 1.0, 1e-9)  # clipped to [1e-7, 1 - 1e-7]
    y = (rng.random(50) < 0.4).astype(np.float32)
    np.testing.assert_allclose(losses.bce_probs(_t(p), _t(y)).item(),
                               float(jax_losses.bce_probs(jnp.asarray(p), jnp.asarray(y))),
                               **TOL)
    outs = {"a": rng.normal(size=50).astype(np.float32), "b": rng.normal(size=50).astype(
        np.float32)}
    labels = {"a": y, "b": 1.0 - y}
    want = jax_losses.multi_task_bce({k: jnp.asarray(v) for k, v in outs.items()},
                                     {k: jnp.asarray(v) for k, v in labels.items()})
    got = losses.multi_task_bce({k: _t(v) for k, v in outs.items()},
                                {k: _t(v) for k, v in labels.items()})
    np.testing.assert_allclose(got.item(), float(want), **TOL)


# -- the models ----------------------------------------------------------------
def _data(seed=0, n=96):
    jschema, data, _ = jax_realistic_multitask(num_examples=n, vocabs=(50, 30, 7, 12, 90, 4),
                                               num_dense=3, embed_dim=8, seed=seed)
    schema, _, _ = realistic_multitask(num_examples=2, vocabs=(50, 30, 7, 12, 90, 4),
                                       num_dense=3, embed_dim=8, seed=seed)
    return jschema, schema, data


MODELS = {
    "esmm": (JaxESMM, ESMM, dict(num_user_fields=3, user_units=(16, 8), item_units=(16, 8),
                                 head_units=(8,)), esmm_params_from_jax),
    "mmoe": (JaxMMoE, MMoE, dict(task_names=("click", "ctcvr"), num_experts=3,
                                 expert_units=(16, 8), tower_units=(8,)), mmoe_params_from_jax),
    "ple": (JaxPLE, PLE, dict(task_names=("click", "ctcvr"), expert_units=(16, 8),
                              tower_units=(8,)), ple_params_from_jax),
    "ple-3": (JaxPLE, PLE, dict(task_names=("click", "ctcvr", "x"), num_levels=3,
                                specific_experts=1, shared_experts=3, expert_units=(12,)),
              ple_params_from_jax),
}


def _pair(name, seed=0):
    jcls, tcls, kw, convert = MODELS[name]
    jschema, schema, data = _data()
    if name == "ple-3":
        data = dict(data, x=data["click"][::-1].copy())
    jm = jcls(jschema, **kw)
    params = jm.init(jax.random.PRNGKey(seed), {k: jnp.asarray(data[k][:2])
                                                for k in ("sparse", "dense")})["params"]
    tm = tcls(schema, **kw)
    state = convert(_np_tree(params), tm)
    assert state.keys() == tm.state_dict().keys()
    tm.load_state_dict(state)
    return jm, params, tm, data, convert


@pytest.mark.parametrize("name", list(MODELS))
def test_multitask_forward_matches_jax(name):
    jm, params, tm, data, _ = _pair(name)
    batch = {k: data[k][:40] for k in ("sparse", "dense")}
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    if name == "esmm":
        np.testing.assert_allclose(got["ctcvr"].numpy(), (got["ctr"] * got["cvr"]).numpy(),
                                   rtol=1e-6)


def _losses(name):
    if name == "esmm":
        def port(o, b):
            return losses.bce_probs(o["ctr"], b["click"]) + losses.bce_probs(o["ctcvr"],
                                                                             b["ctcvr"])

        def jax_loss(o, b):
            return jax_losses.bce_probs(o["ctr"], b["click"]) + jax_losses.bce_probs(
                o["ctcvr"], b["ctcvr"])
        return port, jax_loss
    tasks = MODELS[name][2]["task_names"]
    return (lambda o, b: losses.multi_task_bce(o, {t: b[t] for t in tasks}),
            lambda o, b: jax_losses.multi_task_bce(o, {t: b[t] for t in tasks}))


@pytest.mark.parametrize("name", list(MODELS))
def test_multitask_train_steps_match_jax(name):
    """Three Adam steps: each loss and every parameter after each step
    within 1e-5."""
    jm, params, tm, data, convert = _pair(name, seed=2)
    port_loss, jax_loss = _losses(name)
    jt = JaxTrainer(jm, loss_fn=jax_loss, learning_rate=1e-3)
    jt.init({k: v[:2] for k, v in data.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    tt = Trainer(tm, loss_fn=port_loss, learning_rate=1e-3, device="cpu")
    for s in range(3):
        batch = {k: v[s * 32:(s + 1) * 32] for k, v in data.items()}
        jt.state, jl, _ = jt._train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(s))
        np.testing.assert_allclose(tt.train_step(batch).item(), float(jl), **TOL)
        for key, w in convert(_np_tree(jt.state.params), tm).items():
            np.testing.assert_allclose(tm.state_dict()[key].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{key} after step {s + 1}")


def test_mmoe_runs_on_dense_features_alone():
    jschema, _, data = _data()
    from recsys_tpu.core.features import DenseFeature as JaxDense
    from recsys_tpu.core.features import FeatureSchema as JaxSchema
    from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema
    jm = JaxMMoE(JaxSchema(dense=[JaxDense(f"d{i}") for i in range(3)]), num_experts=2)
    params = jm.init(jax.random.PRNGKey(0), {"dense": jnp.asarray(data["dense"][:2])})["params"]
    tm = MMoE(FeatureSchema(dense=[DenseFeature(f"d{i}") for i in range(3)]), num_experts=2)
    tm.load_state_dict(mmoe_params_from_jax(_np_tree(params), tm))
    assert tm.embedding is None
    want = jm.apply({"params": params}, {"dense": jnp.asarray(data["dense"])})
    with torch.no_grad():
        got = tm({"dense": torch.from_numpy(data["dense"])})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


# -- the data ------------------------------------------------------------------
def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _same_schema(got, want):
    assert [f.name for f in got.dense] == [f.name for f in want.dense]
    assert [(f.name, f.vocab_size, f.embed_dim) for f in got.sparse] == \
        [(f.name, f.vocab_size, f.embed_dim) for f in want.sparse]


@pytest.mark.parametrize("seed", [0, 4])
def test_multitask_generators_are_bit_equal_to_jax(seed):
    kw = dict(num_examples=3000, vocabs=(500, 40, 3, 2000), num_dense=5, seed=seed)
    jschema, jdata, jmeta = jax_realistic_multitask(**kw)
    schema, data, meta = realistic_multitask(**kw)
    _same_schema(schema, jschema)
    _equal(data, jdata)
    assert meta == jmeta
    jschema, jdata = jax_synthetic_multitask(num_examples=500, tasks=("a", "b", "c"), seed=seed)
    schema, data = synthetic_multitask(num_examples=500, tasks=("a", "b", "c"), seed=seed)
    _same_schema(schema, jschema)
    assert np.array_equal(data["sparse"], jdata["sparse"])
    _equal(data["labels"], jdata["labels"])


def _census_pair(train_path, test_path, seed=3):
    out = census.create_census_dataset(str(train_path), str(test_path), seed=seed)
    want = jax_census.create_census_dataset(str(train_path), str(test_path), seed=seed)
    _same_schema(out[0], want[0])
    for got, w in zip(out[1:], want[1:]):
        _equal(got, w)
    return out


def test_realistic_census_through_the_loaders_is_bit_equal_to_jax(tmp_path):
    jtrain, jtest, jmeta = jax_realistic_census(num_train=3000, num_test=1001, seed=2)
    train, test, meta = realistic_census(num_train=3000, num_test=1001, seed=2)
    assert meta == jmeta and list(train) == census.COLUMNS == list(jtrain.columns)
    for got, want in ((train, jtrain), (test, jtest)):
        for c in census.COLUMNS:
            assert np.array_equal(got[c], want[c].to_numpy()), c
    # the JAX runner's files, read by both loaders, and the port's files
    jtrain.to_csv(tmp_path / "j.data", index=False, header=False)
    jtest.to_csv(tmp_path / "j.test", index=False, header=False)
    census.write_columns(str(tmp_path / "p.data"), train)
    census.write_columns(str(tmp_path / "p.test"), test)
    assert (tmp_path / "p.data").read_bytes() == (tmp_path / "j.data").read_bytes()
    assert (tmp_path / "p.test").read_bytes() == (tmp_path / "j.test").read_bytes()
    schema, tr, va, te = _census_pair(tmp_path / "j.data", tmp_path / "j.test")
    assert len(tr["label_income"]) == 3000 and len(va["label_income"]) == 500
    assert len(te["label_income"]) == 501 and 0 < tr["label_marital"].mean() < 1
    # the arrays the columns give without the files
    out = census.build_census_arrays(train, test, seed=3)
    for got, want in zip(out[1:], (tr, va, te)):
        _equal(got, want)


def _row(rng, i, det_ind, det_occ, year):
    row = {c: f" {c}_v{rng.integers(0, 4)}" for c in census.SPARSE_COLS}
    row.update({c: str(rng.integers(0, 90)) for c in census.DENSE_COLS})
    row.update(det_ind_code=det_ind, det_occ_code=det_occ, year=year,
               instance_weight=f"{rng.uniform(100, 900):.2f}",
               income_50k=" 50000+." if i % 3 == 0 else " - 50000.",
               marital_stat=" Never married" if i % 2 else " Divorced")
    return ",".join(row[c] for c in census.COLUMNS)


def test_census_loader_codes_numeric_columns_as_pandas_reads_them(tmp_path):
    """Categorical columns of integers (" 7", "07" both read as 7), of
    floats (" 7.0", "7", "1e1" read as 7.0, 7.0, 10.0: a float column codes
    "7.0"), and of text with numbers in it (kept as written, stripped):
    each package's codes, vocabularies, dense values, labels and splits
    equal, and the codes follow the parsed values."""
    rng = np.random.default_rng(7)
    ints = [" 7", "07", " 12", "3 ", "-2"]
    floats = [" 7.0", "7", "1e1", " 2.50", ".5"]
    text = [" 7", "7.0", " seven", " 12", "7"]
    lines = [_row(rng, i, ints[i % 5], floats[i % 5], text[i % 5]) for i in range(40)]
    (tmp_path / "tr.data").write_text("\n".join(lines[:30]) + "\n\n")
    (tmp_path / "te.test").write_text("\n".join(lines[30:]) + "\n")
    schema, tr, _, _ = _census_pair(tmp_path / "tr.data", tmp_path / "te.test")
    j = {c: i for i, c in enumerate(census.SPARSE_COLS)}
    vocab = {f.name: f.vocab_size for f in schema.sparse}
    assert vocab["det_ind_code"] == 4  # -2, 3, 7, 12
    assert vocab["det_occ_code"] == 4  # 0.5, 2.5, 7.0, 10.0
    assert vocab["year"] == 4          # "12", "7", "7.0", "seven"
    codes = tr["sparse"]
    assert codes[0, j["det_ind_code"]] == codes[1, j["det_ind_code"]]   # " 7" and "07"
    assert codes[0, j["det_occ_code"]] == codes[1, j["det_occ_code"]]   # " 7.0" and "7"
    assert codes[0, j["year"]] == codes[4, j["year"]] != codes[1, j["year"]]  # "7" vs "7.0"


def test_census_loader_refuses_missing_fields_and_short_rows(tmp_path):
    rng = np.random.default_rng(8)
    good = _row(rng, 0, "1", "2", "3")
    (tmp_path / "missing.data").write_text(good + "\n" + good.replace(" 50000+.", "NA") + "\n")
    with pytest.raises(ValueError, match="income_50k.*row 2"):
        census.read_columns(str(tmp_path / "missing.data"))
    (tmp_path / "short.data").write_text(good + "\n" + good.rsplit(",", 1)[0] + "\n")
    with pytest.raises(ValueError, match="row 2 has 41 fields"):
        census.read_columns(str(tmp_path / "short.data"))
