"""The port's DIN slice against the JAX package on the CPU: flax's
``BatchNorm`` (train and eval, the running statistics after three
updates), ``Dice`` and ``PReLU``; ``TargetAttention`` with an all-padding
history; DIN with PReLU and with Dice, its forward from variables
converted with ``din_variables_from_jax`` and three ``Trainer`` steps with
the parameters and the batch statistics after each; early stopping
restoring the BatchNorm buffers with the best weights; and the data:
``build_din_dataset_fast``, ``synthetic_reviews``, ``build_amazon_arrays``
and ``create_amazon_electronic_dataset`` (on JSON and Python-literal dumps
the test writes) bit-equal to JAX's.

Tolerances: f32 on both sides, sums in another order: 1e-5 on outputs,
losses, parameters and statistics; the data bit-equal."""
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data import amazon as jax_amazon
from recsys_tpu.data.realistic import build_din_dataset_fast as jax_build_din_fast
from recsys_tpu.data.realistic import realistic_ratings as jax_realistic_ratings
from recsys_tpu.models.ctr.din import DIN as JaxDIN
from recsys_tpu.ops.attention import TargetAttention as JaxTargetAttention
from recsys_tpu.ops.mlp import Dice as JaxDice
from recsys_tpu.ops.mlp import PReLU as JaxPReLU
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu.train.losses import bce_with_logits as jax_bce
from recsys_tpu_torch.convert import _dense, din_variables_from_jax
from recsys_tpu_torch.data import amazon
from recsys_tpu_torch.data.realistic import build_din_dataset_fast, realistic_ratings
from recsys_tpu_torch.models.ctr.din import DIN
from recsys_tpu_torch.ops.attention import TargetAttention
from recsys_tpu_torch.ops.mlp import BatchNorm, Dice, PReLU
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


class _FlaxBN(fnn.Module):
    """flax's BatchNorm with the port's switches."""
    use_scale: bool = True
    use_bias: bool = True
    epsilon: float = 1e-5

    @fnn.compact
    def __call__(self, x, training):
        return fnn.BatchNorm(use_running_average=not training, use_scale=self.use_scale,
                             use_bias=self.use_bias, epsilon=self.epsilon)(x)


def _inputs(seed, shape=(64, 6), scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale + 1.5
    x[:, 0] = 0.25  # a constant feature: its batch variance is 0 (clipped)
    return x


@pytest.mark.parametrize("kind", ["batch_norm", "no_scale_bias", "dice"])
def test_batch_norm_and_dice_match_flax_in_train_and_eval(kind):
    """Three training calls on three batches (outputs and the running mean
    and var after each), then eval on a fourth, from the same scale, bias
    and alpha."""
    rng = np.random.default_rng(1)
    if kind == "dice":
        jm, tm = JaxDice(), Dice(6)
    elif kind == "no_scale_bias":
        jm = _FlaxBN(use_scale=False, use_bias=False, epsilon=1e-3)
        tm = BatchNorm(6, eps=1e-3, use_scale=False, use_bias=False)
    else:
        jm, tm = _FlaxBN(), BatchNorm(6)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(_inputs(0)), training=False)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        variables.get("params", {}))
    stats = variables["batch_stats"]
    state = {}
    if kind == "dice":
        state["alpha"] = _t(params["alpha"])
    elif kind == "batch_norm":
        state.update(scale=_t(params["BatchNorm_0"]["scale"]),
                     bias=_t(params["BatchNorm_0"]["bias"]))
    tm.load_state_dict(state, strict=False)
    bn = tm.bn if kind == "dice" else tm
    tm.train()
    for step in range(3):
        x = _inputs(step + 1, scale=1.0 + step)
        want, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             training=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        inner = stats["BatchNorm_0"]
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(inner["mean"]), **TOL)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(inner["var"]), **TOL)
    tm.eval()
    x = _inputs(9)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), training=False)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), np.asarray(want), **TOL)


def test_prelu_matches_flax_with_its_gradient_at_zero():
    x = _inputs(2)
    x[:5, 1] = 0.0
    jm = JaxPReLU()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = PReLU(6)
    assert torch.equal(tm.alpha.detach(), torch.full((6,), 0.25))
    jg = jax.grad(lambda xx: jm.apply({"params": params}, xx).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply({"params": params},
                                                                         jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **TOL)
    assert (tx.grad.numpy()[:5, 1] == 1.0).all()  # x = 0 takes the identity branch


def test_target_attention_matches_jax_with_an_all_pad_history():
    rng = np.random.default_rng(4)
    b, length, d = 9, 7, 6
    q = rng.normal(size=(b, d)).astype(np.float32)
    keys = rng.normal(size=(b, length, d)).astype(np.float32)
    mask = rng.random((b, length)) < 0.6
    mask[0] = False  # all padding: equal weights over its pad rows
    mask[1] = True
    jm = JaxTargetAttention((8, 4))
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(q), jnp.asarray(keys),
                     jnp.asarray(mask))["params"]
    tm = TargetAttention(d, (8, 4))
    tm.load_state_dict({f"layers.{i}.{k}": v for i in range(3)
                        for k, v in _dense(_np_tree(params[f"Dense_{i}"])).items()})
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(keys),
                               jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(keys), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0], keys[0].mean(0), **TOL)


# -- DIN ---------------------------------------------------------------------
MAXLEN = 10


def _din_data(seed=0):
    """Both packages' DIN datasets from the same small ratings; they must
    be bit-equal."""
    frame, jmeta = jax_realistic_ratings(num_users=300, num_items=400, seed=seed,
                                         return_meta=True, num_cates=15)
    cols, meta = realistic_ratings(num_users=300, num_items=400, seed=seed, return_meta=True,
                                   num_cates=15)
    kw = dict(maxlen=MAXLEN, embed_dim=8, seed=seed, max_train_positions=4)
    jax_out = jax_build_din_fast(frame, jmeta["item_cate"], jmeta["num_cates"], **kw)
    out = build_din_dataset_fast(cols, meta["item_cate"], meta["num_cates"], **kw)
    return jax_out, out


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _same_schema(got, want):
    assert [(f.name, f.vocab_size, f.embed_dim) for f in got.sparse] == \
        [(f.name, f.vocab_size, f.embed_dim) for f in want.sparse]
    assert [(f.name, f.vocab_size, f.max_len, f.shared_with) for f in got.varlen] == \
        [(f.name, f.vocab_size, f.max_len, f.shared_with) for f in want.varlen]


@pytest.mark.parametrize("seed", [0, 3])
def test_din_dataset_is_bit_equal_to_jax(seed):
    jax_out, out = _din_data(seed)
    _same_schema(out[0], jax_out[0])
    for got, want in zip(out[1:], jax_out[1:]):
        _equal(got, want)
    assert len(out[1]["label"]) > 0 and (out[3]["hist"] == 0).any()


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _din_pair(activation, seed=0):
    (jschema, jtrain, _, _), (schema, train, val, test) = _din_data()
    jm = JaxDIN(jschema, ffn_activation=activation)
    variables = jm.init(jax.random.PRNGKey(seed), _jax_batch({k: v[:4] for k, v in
                                                              jtrain.items()
                                                              if k != "label"}))
    params = variables["params"]
    # the PReLU/Dice slopes start at constants: give them values to compare
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.3)
        if "alpha" in jax.tree_util.keystr(path) else a, params)
    tm = DIN(schema, ffn_activation=activation)
    tm.load_state_dict(din_variables_from_jax(_np_tree(params),
                                              _np_tree(variables["batch_stats"]), tm))
    return jm, params, variables["batch_stats"], tm, (train, val, test)


@pytest.mark.parametrize("activation", ["prelu", "dice"])
def test_din_forward_matches_jax(activation):
    jm, params, stats, tm, (_, _, test) = _din_pair(activation)
    batch = {k: v[:50] for k, v in test.items()}
    tm.eval()
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, _jax_batch(batch)))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == (50,)
    np.testing.assert_allclose(got, want, **TOL)
    # training mode normalises by the batch
    want, _ = jm.apply({"params": params, "batch_stats": stats}, _jax_batch(batch),
                       training=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        np.testing.assert_allclose(tm({k: torch.from_numpy(v) for k, v in batch.items()}).numpy(),
                                   np.asarray(want), **TOL)


def _bce(out, batch):
    from recsys_tpu_torch.train.losses import bce_with_logits
    return bce_with_logits(out, batch["label"])


@pytest.mark.parametrize("activation", ["prelu", "dice"])
def test_din_train_steps_match_jax_with_batch_stats(activation):
    """Three Adam steps: each loss, and every BatchNorm statistic (the entry
    BN's and each Dice's) within 1e-5 after each.  Every parameter is
    within 1e-5 after each step but those cells whose gradient, at some
    step so far, was within 1e-5 of that step's largest: Adam divides such
    a gradient by its own size, so f32 rounding (the gradients agree to
    1e-10 there) moves the cell by up to lr a step either way; they are held
    within 2·lr a step, and at most 1% of the cells end beyond 1e-5.  The
    attention score's last bias is one of them: it adds a constant to every
    score of a softmax, so its gradient is exactly 0."""
    jm, params, stats, tm, (train, _, _) = _din_pair(activation, seed=1)
    jt = JaxTrainer(jm, learning_rate=1e-3)
    jt.init({k: v[:2] for k, v in train.items()})
    jt.state = jt.state.replace(params=params, batch_stats=stats,
                                opt_state=jt.tx.init(params))
    jt._build_steps()
    tt = Trainer(tm, learning_rate=1e-3, device="cpu")
    names = dict(tm.named_parameters())
    small = {}
    for s in range(3):
        batch = {k: v[s * 64:(s + 1) * 64] for k, v in train.items()}
        jb = _jax_batch(batch)

        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": jt.state.batch_stats}, jb,
                              training=True, mutable=["batch_stats"])
            return jax_bce(out, jb["label"])

        grads = din_variables_from_jax(_np_tree(jax.grad(loss)(jt.state.params)),
                                       _np_tree(jt.state.batch_stats), tm)
        top = max(float(grads[n].abs().max()) for n in names)
        for n in names:
            small[n] = small.get(n, False) | (grads[n].abs() <= 1e-5 * top)
        jt.state, jl, _ = jt._train_step(jt.state, jb, jax.random.PRNGKey(s))
        np.testing.assert_allclose(tt.train_step(batch).item(), float(jl), **TOL)
        want = din_variables_from_jax(_np_tree(jt.state.params),
                                      _np_tree(jt.state.batch_stats), tm)
        got = tm.state_dict()
        assert got.keys() == want.keys()
        for name, w in want.items():
            diff = (got[name] - w).abs()
            tol = torch.where(small[name], 2e-3 * (s + 1), 1e-5) if name in small else 1e-5
            assert (diff <= tol).all(), f"{name} after step {s + 1}: {float(diff.max())}"
    shift_free = f"attention.layers.{len(tm.attention.layers) - 1}.bias"
    assert small[shift_free].all()
    off = sum(int(((got[n] - want[n]).abs() > 1e-5).sum()) for n in names)
    assert off <= 1e-2 * sum(p.numel() for p in names.values()), off
    assert not torch.equal(tm.bn.mean, torch.zeros_like(tm.bn.mean))


def test_early_stopping_restores_the_batch_norm_buffers():
    """Validation on flipped labels gets worse as training goes on, so the
    first epoch is the best: after fit the parameters and the BN buffers
    are the copy the hook saw after that epoch, not the last epoch's."""
    _, _, _, tm, (train, _, _) = _din_pair("dice")
    flipped = dict(train, label=1.0 - train["label"])
    seen = []
    tr = Trainer(tm, learning_rate=1e-2, device="cpu")
    hist = tr.fit(train, batch_size=64, epochs=4, val_data=flipped,
                  early_stopping_patience=2, verbose=False,
                  eval_fn=lambda t: seen.append({k: v.clone() for k, v in
                                                 t.model.state_dict().items()}) or {})
    assert np.argmin(hist["val_loss"]) == 0 and len(hist["val_loss"]) == 3
    final = tm.state_dict()
    assert not torch.equal(seen[0]["bn.mean"], seen[-1]["bn.mean"])
    for name in ("bn.mean", "bn.var", "acts.0.bn.mean", "acts.1.bn.var", "bn.scale"):
        assert torch.equal(final[name], seen[0][name]), name


def test_trainer_refuses_history_ids_outside_their_tables():
    _, _, _, tm, (train, _, _) = _din_pair("prelu")
    tr = Trainer(tm, device="cpu")
    for key, vocab in (("hist", tm.schema.field("hist_item").vocab_size),
                       ("hist_cate", tm.schema.field("hist_cate").vocab_size),
                       ("sparse", None)):
        bad = {k: v[:40].copy() for k, v in train.items()}
        bad[key][3, 1] = vocab if vocab is not None else 10 ** 6
        with pytest.raises(ValueError, match="outside"):
            tr.predict(bad, batch_size=16)


# -- the Amazon pipeline -------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(num_users=60, num_items=40, seed=0),
                                dict(num_users=120, num_items=25, seed=5)])
def test_amazon_arrays_are_bit_equal_to_jax(kw):
    jreviews, jmeta = jax_amazon.synthetic_reviews(**kw)
    reviews, meta = amazon.synthetic_reviews(**kw)
    for got, want in ((reviews, jreviews), (meta, jmeta)):
        assert list(got) == list(want.columns)
        for c in got:
            assert np.array_equal(got[c], want[c].to_numpy().astype(got[c].dtype)), c
    jax_out = jax_amazon.build_amazon_arrays(jreviews, jmeta, maxlen=12)
    out = amazon.build_amazon_arrays(reviews, meta, maxlen=12)
    _same_schema(out[0], jax_out[0])
    for got, want in zip(out[1:], jax_out[1:]):
        _equal(got, want)


def test_amazon_files_parse_to_the_jax_arrays(tmp_path):
    """A reviews dump in JSON lines, unsorted, with a user of two reviews
    (skipped) and reviews of an item the meta does not know (dropped), and
    a meta dump of Python-literal lines (single quotes)."""
    rng = np.random.default_rng(6)
    users = [f"R{rng.integers(0, 30):03d}" for _ in range(400)]
    users += ["LONELY", "LONELY"]
    asins = [f"B{rng.integers(0, 50):03d}" for _ in range(len(users))]
    asins[5] = "UNKNOWN"
    times = rng.integers(1_300_000_000, 1_400_000_000, len(users))
    times[10] = times[11]  # a tie, kept in file order by the stable sort
    with open(tmp_path / "reviews.json", "w") as f:
        for u, a, t in zip(users, asins, times):
            f.write(json.dumps({"reviewerID": u, "asin": a, "unixReviewTime": int(t),
                                "overall": 5.0}) + "\n")
    with open(tmp_path / "meta.json", "w") as f:
        for i in range(50):
            cats = [["Electronics", f"c{i % 7}"], ["Electronics", "Sub", f"leaf{i % 4}"]]
            f.write(repr({"asin": f"B{i:03d}", "categories": cats, "title": "it's"}) + "\n")
    paths = (str(tmp_path / "reviews.json"), str(tmp_path / "meta.json"))
    jax_out = jax_amazon.create_amazon_electronic_dataset(*paths, maxlen=8)
    out = amazon.create_amazon_electronic_dataset(*paths, maxlen=8)
    _same_schema(out[0], jax_out[0])
    for got, want in zip(out[1:], jax_out[1:]):
        _equal(got, want)
    assert out[0].field("cate").vocab_size == 5  # the 4 leaves and the pad
    assert len(out[3]["label"]) == 2 * 30


def test_parse_line_reads_json_and_python_literals():
    row = {"asin": "B1", "categories": [["a", "b"]]}
    assert amazon._parse_line(json.dumps(row)) == row == amazon._parse_line(repr(row))
