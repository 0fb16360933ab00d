"""The port's SASRec slice against the JAX package on the CPU: the
attention modules against flax, SASRec logits in both scoring schemes with
padded histories, three ``Trainer.train_step``s against the JAX
``Trainer``, ``predict`` with dict outputs, the loss and ranking metric, the
numpy dataset builder (bit-equal) and dropout.  Weights come from the JAX
models through ``convert``; inputs from numpy with a seed.

On the CPU the JAX ``sdpa`` takes its materialised softmax, which spreads a
query row with no key to attend uniformly over every key, while the port
(plain flash versions) gives 0 there.  SASRec zeroes pad positions after
every block, so the models agree on padded histories all the same; the
module tests keep key 0 visible so that no row is fully masked.

Tolerances: f32 on both sides, sums in another order: 1e-5 on
activations, logits and the loss (measured differences in ROADMAP Queue
3).  Parameters after three Adam steps: as tests/test_torch_training.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data.movielens import build_sasrec_dataset as jax_build_sasrec
from recsys_tpu.data.movielens import synthetic_ratings as jax_synthetic_ratings
from recsys_tpu.models.match.sasrec import SASRec as JaxSASRec
from recsys_tpu.ops import attention as jax_ops
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train import metrics as jax_metrics
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import (attention_from_jax, sasrec_params_from_jax,
                                      transformer_block_from_jax)
from recsys_tpu_torch.data.movielens import build_sasrec_dataset, synthetic_ratings
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.ops.attention import Dropout, MultiHeadAttention, TransformerBlock
from recsys_tpu_torch.train.losses import pairwise_bce
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.metrics import hit_rate_ndcg_at_k

TOL = dict(rtol=1e-5, atol=1e-5)
MAXLEN, EMBED, HEADS = 12, 16, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x_and_mask(rng, b=3, s=10, d=EMBED):
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = rng.random((b, s)) > 0.3
    mask[:, 0] = True  # no fully masked row (see the module docstring)
    return x, mask


# -- modules -------------------------------------------------------------------
MHA_CASES = {
    # id: (model_dim, use_residual, out_proj, causal, with mask)
    "residual": (None, True, False, False, True),
    "plain-causal": (None, False, False, True, True),
    "out_proj-nomask": (None, False, True, False, False),
    "wider-residual-causal": (24, True, True, True, True),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_multi_head_attention_matches_flax(case):
    model_dim, residual, out_proj, causal, with_mask = MHA_CASES[case]
    rng = np.random.default_rng(0)
    x, mask = _x_and_mask(rng)
    mask = mask if with_mask else None
    jm = jax_ops.MultiHeadAttention(num_heads=HEADS, model_dim=model_dim,
                                    use_residual=residual, out_proj=out_proj, causal=causal)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), mask=jmask)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), mask=jmask)
    tm = MultiHeadAttention(EMBED, HEADS, model_dim=model_dim, use_residual=residual,
                            out_proj=out_proj, causal=causal)
    tm.load_state_dict(attention_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_matches_flax(causal):
    rng = np.random.default_rng(1)
    x, mask = _x_and_mask(rng)
    jm = jax_ops.TransformerBlock(num_heads=HEADS, ffn_dim=32, dropout_rate=0.2,
                                  causal=causal)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tm = TransformerBlock(EMBED, num_heads=HEADS, ffn_dim=32, dropout_rate=0.2,
                          causal=causal).eval()
    tm.load_state_dict(transformer_block_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropout_scales_in_training_reproducibly_and_is_the_identity_in_eval():
    x = torch.ones(64, 64)
    drop = Dropout(0.25)
    drop.generator = torch.Generator().manual_seed(5)
    y = drop.train()(x)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < kept.float().mean() < 0.8
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(x), y)  # the same bits from the same seed
    assert not torch.equal(drop(x), y)  # and new bits from the next draw
    assert drop.eval()(x) is x


def test_trainer_seeds_every_dropout_from_its_seed():
    def run(seed):
        model = SASRec(num_items=30, embed_dim=8, num_blocks=2, max_len=6, dropout_rate=0.5)
        torch.manual_seed(0)  # the same weights
        model.load_state_dict(SASRec(num_items=30, embed_dim=8, num_blocks=2,
                                     max_len=6).state_dict())
        tr = Trainer(model, loss_fn=_loss, seed=seed, device="cpu")
        gens = {id(m.generator) for m in model.modules() if isinstance(m, Dropout)}
        assert gens == {id(tr.generator)}
        batch = {"hist": np.arange(12, dtype=np.int32).reshape(2, 6) + 1,
                 "pos": np.array([3, 4], np.int32), "neg": np.array([[5], [6]], np.int32)}
        return float(tr.train_step(batch))

    assert run(1) == run(1) != run(2)


# -- the model -----------------------------------------------------------------
def _dataset(all_positions, maxlen=MAXLEN):
    return build_sasrec_dataset(synthetic_ratings(num_users=40, num_items=50), maxlen=maxlen,
                                all_positions=all_positions)


def _pair(num_items, dropout_rate=0.0, seed=0):
    jm = JaxSASRec(num_items=num_items, embed_dim=EMBED, num_blocks=2, num_heads=HEADS,
                   max_len=MAXLEN, dropout_rate=dropout_rate)
    sample = {"hist": jnp.zeros((2, MAXLEN), jnp.int32), "pos": jnp.ones((2,), jnp.int32),
              "neg": jnp.ones((2, 1), jnp.int32)}
    params = jm.init(jax.random.PRNGKey(seed), sample)["params"]
    tm = SASRec(num_items=num_items, embed_dim=EMBED, num_blocks=2, num_heads=HEADS,
                max_len=MAXLEN, dropout_rate=dropout_rate)
    tm.load_state_dict(sasrec_params_from_jax(_np_tree(params), tm))
    return jm, params, tm.eval()


@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_sasrec_logits_match_jax_on_padded_histories(all_positions):
    ni, train, _, test = _dataset(all_positions)
    jm, params, tm = _pair(ni)
    for data in (train, test):
        batch = {k: v[:32] for k, v in data.items()}
        assert (batch["hist"] == 0).any()  # front padding, fully masked rows
        want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                       err_msg=key)


def _loss(out, batch):
    """``cli sasrec``'s loss (recsys_tpu/cli.py)."""
    return pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))


def _jax_loss(out, batch):
    return jax_losses.pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))


STEPS, BATCH, LR = 3, 16, 1e-3


@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_train_steps_match_jax(all_positions):
    ni, train, _, _ = _dataset(all_positions)
    jm, params, tm = _pair(ni)
    jt = JaxTrainer(jm, loss_fn=_jax_loss, learning_rate=LR)
    jt.init({k: v[:2] for k, v in train.items()})
    jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
    jt._build_steps()
    tt = Trainer(tm, loss_fn=_loss, learning_rate=LR, device="cpu")
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in train.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL,
                                   err_msg=f"loss of step {s + 1}")

    # every Adam step moves a cell by about lr; a gradient within the two
    # frameworks' rounding noise of zero may move its cell the other way
    want = sasrec_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert diff.max() <= 2 * LR * STEPS * 1.001, name
        assert (diff > 1e-5).float().mean() <= 1e-3, name
    # Adam moments: gradients summed in another order, whose cancellations
    # leave some cells near zero, so within 1e-5 of each tensor's largest
    # magnitude (measured: at most 4e-7 of it)
    adam = jt.state.opt_state[0]
    named = dict(tm.named_parameters())
    for jtree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        for name, w in sasrec_params_from_jax(_np_tree(jtree), tm).items():
            diff = (tt.optimizer.state[named[name]][key] - w).abs().max()
            assert diff <= 1e-5 * w.abs().max(), (name, key, float(diff))


@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_predict_returns_dict_outputs_with_a_ragged_tail(all_positions):
    ni, _, _, test = _dataset(all_positions)
    n = len(test["hist"])
    assert n % 16 != 0
    _, _, tm = _pair(ni)
    tr = Trainer(tm, device="cpu")
    out = tr.predict(test, batch_size=16)
    assert out["pos_logits"].shape == (n,) and out["neg_logits"].shape == (n, 20)
    with torch.no_grad():
        want = tm({k: torch.from_numpy(v) for k, v in test.items()})
    for key in out:
        np.testing.assert_allclose(out[key], want[key].numpy(), **TOL)
    parts = []
    assert tr.predict(test, batch_size=16,
                      consumer=lambda o, start: parts.append((start, o))) is None
    assert [s for s, _ in parts] == list(range(0, n, 16))
    np.testing.assert_array_equal(np.concatenate([o["pos_logits"] for _, o in parts]),
                                  out["pos_logits"])


@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_evaluate_loss_matches_jax_with_a_ragged_tail(all_positions):
    ni, _, val, _ = _dataset(all_positions)
    assert len(val["hist"]) % 16 != 0
    jm, params, tm = _pair(ni)
    jt = JaxTrainer(jm, loss_fn=_jax_loss)
    jt.init({k: v[:2] for k, v in val.items()})
    jt.state = jt.state.replace(params=params)
    want = jt.evaluate_loss(val, batch_size=16)
    got = Trainer(tm, loss_fn=_loss, device="cpu").evaluate_loss(val, batch_size=16)
    np.testing.assert_allclose(got, want, **TOL)


def test_trainer_refuses_item_ids_outside_the_table():
    ni, train, _, test = _dataset(False)
    _, _, tm = _pair(ni)
    tr = Trainer(tm, loss_fn=_loss, device="cpu")
    bad = dict(test, neg=test["neg"].copy())
    bad["neg"][3, 2] = ni
    with pytest.raises(ValueError, match="neg ids"):
        tr.predict(bad, batch_size=16)
    bad = dict(train, hist=train["hist"].copy())
    bad["hist"][0, -1] = -1
    with pytest.raises(ValueError, match="hist ids"):
        tr.fit(bad, batch_size=len(bad["hist"]), epochs=1, verbose=False)


def test_fit_then_rank_like_cli_sasrec():
    """``cli sasrec``'s flow at a small size on the plain path: fit, then
    predict the test rows and rank each positive among 20 negatives."""
    ni, train, _, test = _dataset(True, maxlen=20)
    tm = SASRec(num_items=ni, embed_dim=EMBED, num_heads=1, max_len=20)
    tr = Trainer(tm, loss_fn=_loss, learning_rate=1e-2, device="cpu")
    hist = tr.fit(train, batch_size=16, epochs=3, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    out = tr.predict(test)
    hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)
    assert 0.0 <= ndcg <= hr <= 1.0


# -- loss, metric, data --------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_pairwise_bce_matches_jax(masked):
    rng = np.random.default_rng(6)
    shape = (8, 5) if masked else (8,)
    pos = (rng.standard_normal(shape) * 20).astype(np.float32)
    neg = (rng.standard_normal((*shape, 1 if masked else 4)) * 20).astype(np.float32)
    mask = rng.random(shape) > 0.4 if masked else None
    want = jax_losses.pairwise_bce(jnp.asarray(pos), jnp.asarray(neg),
                                   mask=None if mask is None else jnp.asarray(mask))
    got = pairwise_bce(torch.from_numpy(pos), torch.from_numpy(neg),
                       mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_hit_rate_ndcg_matches_jax():
    rng = np.random.default_rng(7)
    pos = rng.standard_normal(200).astype(np.float32)
    neg = rng.standard_normal((200, 20)).astype(np.float32)
    neg[:5] = pos[:5, None]  # ties do not outrank the positive
    want = jax_metrics.hit_rate_ndcg_at_k(jnp.asarray(pos), jnp.asarray(neg), k=10)
    got = hit_rate_ndcg_at_k(pos, neg, k=10)
    np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-6)


@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_build_sasrec_dataset_is_bit_equal_to_jax(all_positions):
    frame = jax_synthetic_ratings(num_users=120, num_items=80, seed=3)
    cols = synthetic_ratings(num_users=120, num_items=80, seed=3)
    for name, col in cols.items():
        np.testing.assert_array_equal(col, frame[name].to_numpy())
    want = jax_build_sasrec(frame, maxlen=15, all_positions=all_positions)
    got = build_sasrec_dataset(cols, maxlen=15, all_positions=all_positions)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
