"""The port's routes for shapes outside a kernel's domain, against the JAX
package on the CPU.  Each op decides from the shape alone, the same on every
device, whether its kernel takes a call (``dot_in_domain``,
``flash_in_domain``, ``topk.in_domain``, each the mirror of its kernel's
own refusal) or the torch ops that compute what the JAX package's XLA route
computes there:

- AutoInt at D = 8 (two heads of width 4, the JAX CLI's default), logits
  and three train steps against the JAX Trainer;
- SASRec at head width 12, logits against flax;
- ``DotInteraction`` at F = 80 (JAX takes XLA above F = 64), forward and
  gradient, and at a width past the kernel's shared memory;
- top-k at D = 1024, past the top-k kernel's shared memory;
- each domain function, and the route each op takes at a refused shape and
  at the main path's shapes (spies on the ``dispatch`` functions).

Tolerances: f32 on both sides, sums in another order: 1e-5 on logits,
outputs, gradients and losses; scores at D = 1024 (sums of 1024 products,
of magnitude about 30) 1e-5 relative and 1e-4 absolute, and equal indices;
parameters after three Adam steps as tests/test_torch_ctr_models.py (a
cell moves by about lr a step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data.synthetic import synthetic_ctr as jax_synthetic_ctr
from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.models.ctr.autoint import AutoInt as JaxAutoInt
from recsys_tpu.models.match.sasrec import SASRec as JaxSASRec
from recsys_tpu.train import retrieval as jax_retrieval
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import ctr_params_from_jax, sasrec_params_from_jax
from recsys_tpu_torch.data.movielens import build_sasrec_dataset, synthetic_ratings
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import attention as attn_ref
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import topk as topk_ref
from recsys_tpu_torch.models.ctr.autoint import AutoInt
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.ops.attention import MultiHeadAttention
from recsys_tpu_torch.ops.interactions import DotInteraction
from recsys_tpu_torch.train import retrieval
from recsys_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
LR, BATCH, STEPS = 1e-3, 32, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the calls that reach each kernel's wrapper."""
    calls = {"dot": 0, "flash": 0, "topk": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(dispatch, "dot_interaction", spy("dot", dispatch.dot_interaction))
    monkeypatch.setattr(dispatch, "flash_attention_fwd",
                        spy("flash", dispatch.flash_attention_fwd))
    monkeypatch.setattr(dispatch, "topk_scores_fused", spy("topk", dispatch.topk_scores_fused))
    return calls


# -- the domain functions ----------------------------------------------------------
def test_dot_in_domain_takes_the_main_shapes_and_refuses_the_rest():
    assert int_ref.dot_in_domain(27, 16, False) and int_ref.dot_in_domain(27, 16, True)
    assert int_ref.dot_in_domain(80, 8, False)  # wider than the first design's 48 KB
    assert int_ref.dot_in_domain(1, 8, True) and not int_ref.dot_in_domain(1, 8, False)
    assert not int_ref.dot_in_domain(80, 800, False)
    assert not int_ref.dot_in_domain(27, 0, False)
    # both edges at D = 128: the last F whose example fits, and the next
    last = max(f for f in range(2, 400) if int_ref.dot_in_domain(f, 128, False))
    assert int_ref.dot_example_bytes(last, 128, False) <= int_ref.DOT_SMEM_BYTES
    assert int_ref.dot_example_bytes(last + 1, 128, False) > int_ref.DOT_SMEM_BYTES
    assert last == 236
    # the first design's domain (one example in 48 KB, row stride D | 1,
    # its pair table beside) lies inside the new one
    for f in range(2, 160):
        for d in (1, 2, 3, 5, 8, 16, 33, 64, 128, 256, 1000):
            p = int_ref.num_pairs(f, False)
            if f * (d | 1) * 4 + p * 4 <= 48 * 1024:
                assert int_ref.dot_in_domain(f, d, False), (f, d)


def test_flash_in_domain_is_every_multiple_of_8_up_to_128():
    assert [d for d in range(0, 200) if attn_ref.flash_in_domain(d)] == list(range(8, 129, 8))


def test_topk_in_domain_refuses_k_outside_1_16_and_widths_past_shared_memory():
    assert topk_ref.in_domain(10, 19_203, 32) and topk_ref.in_domain(10, 1_000_000, 64)
    assert not topk_ref.in_domain(17, 1000, 32) and not topk_ref.in_domain(10, 10, 32)
    assert topk_ref.in_domain(10, 1000, 128) and not topk_ref.in_domain(10, 1000, 129)
    assert topk_ref.in_domain(10, 1000, 4) and topk_ref.in_domain(10, 1000, 1)
    assert not topk_ref.in_domain(10, 1000, 1024) and not topk_ref.in_domain(10, 1000, 0)


# -- DotInteraction ----------------------------------------------------------------
@pytest.mark.parametrize("f, d, routed", [(80, 8, False), (80, 800, True), (27, 16, False)])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_jax_on_both_routes(routes, f, d, routed, self_interaction):
    rng = np.random.default_rng(f + d)
    x = rng.standard_normal((5, f, d)).astype(np.float32) * np.float32(0.3)
    w = rng.standard_normal((5, int_ref.num_pairs(f, self_interaction))).astype(np.float32)

    def jax_loss(xj):
        return jnp.sum(jax_dispatch.dot_interaction(xj, self_interaction=self_interaction)
                       * w)

    want = jax_dispatch.dot_interaction(jnp.asarray(x), self_interaction=self_interaction)
    want_dx = jax.grad(jax_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = DotInteraction(self_interaction)(xt)
    (got * torch.from_numpy(w)).sum().backward()
    assert routes["dot"] == (0 if routed else 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)


# -- top-k -------------------------------------------------------------------------
@pytest.mark.parametrize("d, routed", [(1024, True), (32, False)])
def test_topk_scores_at_wide_d_matches_jax(routes, d, routed):
    rng = np.random.default_rng(d)
    qs = rng.standard_normal((9, d)).astype(np.float32)
    items = rng.standard_normal((300, d)).astype(np.float32)
    items[200] = items[7]  # an exact tie: the lower id first on both sides
    wv, wi = jax_retrieval.topk_scores(jnp.asarray(qs), jnp.asarray(items), k=10)
    for fn in (retrieval.topk_scores, retrieval.topk_scores_streaming):
        gv, gi = fn(torch.from_numpy(qs), torch.from_numpy(items), k=10)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert routes["topk"] == (0 if routed else 2)


# -- attention ---------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d, heads, routed", [(8, 2, True), (24, 2, True), (16, 2, False)])
def test_attention_route_has_the_flash_semantics(routes, d, heads, routed, causal):
    """The materialised route against the plain flash forward and backward
    at the same head width: every row with a key alike, a row with none 0
    on both routes and in its gradients."""
    rng = np.random.default_rng(d)
    mask = rng.random((3, 7)) > 0.4
    mask[0] = False  # example 0 has no key at all
    mask[1, 0] = True
    mha = MultiHeadAttention(d, heads, use_residual=False, causal=causal)
    x = torch.from_numpy(rng.standard_normal((3, 7, d)).astype(np.float32))
    mt = torch.from_numpy(mask)
    q = torch.from_numpy(rng.standard_normal((3, heads, 7, d // heads)).astype(np.float32))
    k, v = q.roll(1, 2).clone(), q.roll(2, 2).clone()
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn_ref.materialised_attention(*qkv, mt, causal)
    out.backward(do)
    want, lse = attn_ref.flash_attention_fwd(q, k, v, mt, causal)
    want_d = attn_ref.flash_attention_bwd(q, k, v, mt, want, lse, do, causal)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), **TOL)
    assert not out[0].any()
    for got, w in zip(qkv, want_d):
        np.testing.assert_allclose(got.grad.numpy(), w.numpy(), **TOL)
    with torch.no_grad():
        mha(x, mask=mt)
    assert routes["flash"] == (0 if routed else 1)


# -- AutoInt at D = 8 --------------------------------------------------------------
def _autoint_pair(n, seed=0):
    kw = dict(num_examples=n, num_dense=4, num_sparse=5, vocab_size=1000, embed_dim=8,
              seed=seed)
    jschema, data = jax_synthetic_ctr(**kw)
    schema, _ = synthetic_ctr(**kw)
    jm = JaxAutoInt(jschema)  # 3 layers of 2 heads over D = 8: head width 4
    sample = {k: jnp.asarray(v[:8]) for k, v in data.items() if k != "label"}
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), sample)["params"])
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.01, a.shape).astype(np.float32), params)
    tm = AutoInt(schema)
    tm.load_state_dict(ctr_params_from_jax(params, tm))
    return jm, params, tm, data


def test_autoint_at_d8_logits_match_jax(routes):
    jm, params, tm, data = _autoint_pair(64)
    batch = {k: v[:48] for k, v in data.items()}
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert routes["flash"] == 0  # head width 4: every layer takes the route
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_autoint_at_d8_three_train_steps_match_jax(routes):
    jm, params, tm, data = _autoint_pair(STEPS * BATCH)
    jt = JaxTrainer(jm, learning_rate=LR)
    jt.init({k: v[:8] for k, v in data.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state = jt.state.replace(params=jparams, opt_state=jt.tx.init(jparams))
    jt._build_steps()
    tt = Trainer(tm, learning_rate=LR, device="cpu")
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL,
                                   err_msg=f"loss of step {s + 1}")
    assert routes["flash"] == 0
    # every Adam step moves a cell by about lr; a gradient within the two
    # frameworks' rounding noise of zero may move its cell the other way
    want = ctr_params_from_jax(_np_tree(jt.state.params), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        diff = (got[key] - w).abs()
        assert diff.max() <= 2 * LR * STEPS * 1.001, key
        assert (diff > 1e-5).float().mean() <= 1e-3, key


# -- SASRec at head width 12 -------------------------------------------------------
@pytest.mark.parametrize("all_positions", [False, True], ids=["prefix", "all-position"])
def test_sasrec_at_head_width_12_logits_match_flax(routes, all_positions):
    maxlen, embed, heads = 12, 24, 2
    ni, train, _, test = build_sasrec_dataset(synthetic_ratings(num_users=40, num_items=50),
                                              maxlen=maxlen, all_positions=all_positions)
    jm = JaxSASRec(num_items=ni, embed_dim=embed, num_blocks=2, num_heads=heads,
                   max_len=maxlen, dropout_rate=0.0)
    sample = {"hist": jnp.zeros((2, maxlen), jnp.int32), "pos": jnp.ones((2,), jnp.int32),
              "neg": jnp.ones((2, 1), jnp.int32)}
    params = jm.init(jax.random.PRNGKey(0), sample)["params"]
    tm = SASRec(num_items=ni, embed_dim=embed, num_blocks=2, num_heads=heads,
                max_len=maxlen, dropout_rate=0.0)
    tm.load_state_dict(sasrec_params_from_jax(_np_tree(params), tm))
    tm.eval()
    for data in (train, test):
        batch = {k: v[:32] for k, v in data.items()}
        assert (batch["hist"] == 0).any()  # front padding: rows with no key
        want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                       err_msg=key)
    assert routes["flash"] == 0
