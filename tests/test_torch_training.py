"""The port's training slice against the JAX package on the CPU: the fused
MLP backward, the dot interaction's gradient, the BCE loss, whole
``train_step``s of a small DLRM from the same weights on the same batches,
``fit`` with the fused optimizer against dense Adam, and ``evaluate_loss``.
The JAX side runs its Pallas kernels in interpret mode (or, where the JAX
package routes around them on the CPU, its XLA path); the port runs its
plain versions.  Inputs come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlp_bwd_check
from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.kernels.pallas.mlp_tpu import mlp_bwd_pallas
from recsys_tpu.train import losses as jax_losses
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import embedding_state_from_jax, params_from_jax
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels.mlp import mlp_backward
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.train.losses import bce_with_logits
from recsys_tpu_torch.train.loop import Trainer
from test_torch_dlrm import TOL, build_pair


def _mlp_params(dims, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(rng.standard_normal((1, b)) * 0.1).astype(np.float32) for b in dims[1:]]
    return ws, bs


# -- (c) fused MLP backward ----------------------------------------------------
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("b", [48, 40])
def test_mlp_backward_matches_pallas_interpret(mm_bf16, b):
    """The Pallas kernel reads a ragged last tile's missing rows as NaN in
    interpret mode (its dW and db come out NaN), so a batch that is not a
    multiple of the tile is held against the kernel on the batch padded
    with zero rows, which add nothing to any gradient."""
    dims, tile = [13, 48, 32, 8, 1], 16
    ws, bs = _mlp_params(dims, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, dims[0])).astype(np.float32)
    g = rng.standard_normal((b, dims[-1])).astype(np.float32)
    pad = -b % tile
    xp = np.concatenate([x, np.zeros((pad, dims[0]), np.float32)])
    gp = np.concatenate([g, np.zeros((pad, dims[-1]), np.float32)])
    out = mlp_bwd_pallas(jnp.asarray(xp), jnp.asarray(gp), [jnp.asarray(w) for w in ws],
                         [jnp.asarray(v) for v in bs], tile_b=tile, mm_bf16=mm_bf16,
                         interpret=True)
    n = len(ws)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(v) for v in bs]
    dx, dws, dbs = mlp_backward(tx, tg, tw, tb, mm_bf16)
    assert dx.shape == (b, dims[0]) and [d.shape for d in dbs] == [v.shape for v in tb]
    # the same roundings at the same places; an f32 sum in another order can
    # still round a value to the neighbouring bf16 (2^-8 relative)
    rtol = 2e-2 if mm_bf16 else 1e-5
    np.testing.assert_allclose(dx.numpy(), np.asarray(out[0])[:b], rtol=rtol, atol=rtol)
    sw, sb = mlp_bwd_check.term_scales(tx, tg, tw, tb)
    for got, want, scale in zip(dws + dbs, out[1:], sw + sb):
        assert (np.abs(got.numpy() - np.asarray(want)) <= rtol * scale.numpy() + 1e-7).all()


@pytest.mark.parametrize("mm_bf16", [False, True])
def test_mlp_backward_exact_on_integer_values(mm_bf16):
    """The exact check of the card's MLP backward kernel rests on this: on
    mlp_bwd_check.exact_case's integer values every sum is exact in f32, so
    the plain version equals the same chain summed in float64 bit for bit,
    at the top tower's widths."""
    dims = [367, 1024, 1024, 512, 256, 1]
    x, g, ws, bs = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                    [torch.from_numpy(t) for t in a]
                    for a in mlp_bwd_check.exact_case(np.random.default_rng(3), 96, dims))
    assert mlp_bwd_check.largest_term_sum(x, g, ws, bs) < mlp_bwd_check.EXACT_LIMIT
    got = mlp_backward(x, g, ws, bs, mm_bf16)
    want = mlp_bwd_check.f64_chain(x, g, ws, bs, mm_bf16)
    for u, v in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        assert torch.equal(u.double(), v)


# -- (d) the dot interaction's gradient ----------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_gradient_matches_jax(dtype, self_interaction):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 9, 8)).astype(np.float32)
    f = 9
    p = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    w = rng.normal(size=(6, p)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)

    def loss(v):
        out = jax_dispatch.dot_interaction(v, self_interaction=self_interaction,
                                           interpret=True)
        return jnp.sum(out * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x, jdt)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (dispatch.DotInteraction.apply(tx, self_interaction) * torch.from_numpy(w)).sum().backward()
    assert tx.grad.dtype == tdt
    # both sum exact products in f32 in another order; bf16 then rounds once
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(), want, **tol)


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal(64) * 30).astype(np.float32)
    labels = (rng.random(64) < 0.5).astype(np.float32)
    want = float(jax_losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


# -- (e) train steps against the JAX Trainer -----------------------------------
CASES = {
    # id: (compute, fused_mlps, dense_microbatch, embedding_optimizer)
    "f32-dense": ("f32", False, 1, None),
    "f32-fused_adam": ("f32", False, 1, "fused_adam"),
    "f32-fused_rowwise_adagrad": ("f32", False, 1, "fused_rowwise_adagrad"),
    "bf16-fusedmlp-fused_adam": ("bf16", True, 4, "fused_adam"),
    "bf16-fusedmlp-fused_rowwise_adagrad": ("bf16", True, 4, "fused_rowwise_adagrad"),
}
STEPS, BATCH, LR = 3, 32, 1e-3
# Loss per step: the logits' tolerances of tests/test_torch_dlrm.py.
# Parameters after the steps: every Adam step moves a cell by about lr, and
# by less than 2·lr·steps in all; a gradient within the two frameworks'
# rounding noise of zero can move its cell the other way, so the cells that
# differ by more than 1e-5 (f32) or 1e-4 (bf16) are allowed as a share.
P_THRESH = {"f32": 1e-5, "bf16": 1e-4}
P_SHARE = {"f32": 1e-3, "bf16": 2e-2}
# Optimizer state: f32 sums in another order (f32); bf16 roundings of the
# cotangent that a sum in another order can move by one bf16 ulp (bf16).
STATE_TOL = {"f32": dict(rtol=1e-4, atol=1e-9), "bf16": dict(rtol=2e-2, atol=1e-7)}


def _close_by_share(name, got, want, compute):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 2 * LR * STEPS * 1.001, (name, diff.max())
    share = (diff > P_THRESH[compute]).mean()
    assert share <= P_SHARE[compute], (name, share)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    compute, fused, nm, opt = CASES[case]
    fused_bf16 = compute == "bf16"
    jm, params, tm, data = build_pair(compute, fused, nm, num_examples=STEPS * BATCH,
                                      sparse_embed_grads=opt is not None)
    jt = JaxTrainer(jm, learning_rate=LR, embedding_optimizer=opt,
                    embedding_fused_bf16=fused_bf16)
    jt.init({k: v[:8] for k, v in data.items()})
    jt.state = jt.state.replace(params=params)
    jt._build_steps()
    tt = Trainer(tm, learning_rate=LR, embedding_optimizer=opt,
                 embedding_fused_bf16=fused_bf16, device="cpu")
    for s in range(STEPS):
        batch = {k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
        jb = dict(batch)
        if opt is not None:
            jb.update(jt._streaming_prep(batch["sparse"]))
        jt.state, jloss, _ = jt._train_step(
            jt.state, {k: jnp.asarray(v) for k, v in jb.items()}, jax.random.PRNGKey(s))
        tloss = tt.train_step(batch)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL[compute],
                                   err_msg=f"loss of step {s + 1}")
    assert tt.step == STEPS

    np_params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    want = params_from_jax(np_params, tm.schema, tm)
    got = tt.model.state_dict()
    for name, w in want.items():
        _close_by_share(name, got[name].float().numpy(), w.float().numpy(), compute)
    if opt is None:
        return
    jstate = embedding_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.opt_state["emb"]), tm.schema, tm)
    assert jstate.keys() == tt.emb_state.keys()
    for name, st in jstate.items():
        for k, w in st.items():
            np.testing.assert_allclose(tt.emb_state[name][k].numpy(), w.numpy(),
                                       **STATE_TOL[compute], err_msg=f"{name}.{k}")


def test_tables_get_no_autograd_gradient_under_the_fused_optimizer():
    _, _, tm, data = build_pair(num_examples=32, sparse_embed_grads=True)
    tt = Trainer(tm, embedding_optimizer="fused_adam", device="cpu")
    before = tm.embedding.table_0.detach().clone()
    tt.train_step(data)
    assert all(tm.embedding.table(g).grad is None for g in tm.embedding.groups())
    assert not torch.equal(tm.embedding.table_0.detach(), before)
    table_ids = {id(tm.embedding.table(g)) for g in tm.embedding.groups()}
    assert not table_ids & {id(p) for grp in tt.optimizer.param_groups for p in grp["params"]}


def test_trainer_refuses_what_is_not_ported_or_has_no_tap():
    _, _, tm, _ = build_pair()
    with pytest.raises(ValueError, match="not ported"):
        Trainer(tm, embedding_optimizer="lazy_adam", device="cpu")
    with pytest.raises(ValueError, match="not in"):
        Trainer(tm, embedding_optimizer="sgd", device="cpu")
    with pytest.raises(ValueError, match="sparse_embed_grads"):
        Trainer(tm, embedding_optimizer="fused_adam", device="cpu")


# -- (f) fit: fused Adam tracks dense Adam -------------------------------------
def test_fit_fused_adam_matches_dense_adam():
    """The port's mirror of tests/test_streaming_embed.py::
    test_trainer_fused_adam_matches_dense_optax, with its tolerance."""
    schema, data = synthetic_ctr(num_examples=1024, num_dense=4, num_sparse=5,
                                 vocab_size=64, embed_dim=8, seed=7)

    def run(fused):
        torch.manual_seed(0)
        model = DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                     sparse_embed_grads=fused, device="cpu")
        kw = dict(learning_rate=1e-2, seed=11, device="cpu")
        if fused:
            kw.update(embedding_optimizer="fused_adam", embedding_fused_bf16=False)
        return Trainer(model, **kw).fit(data, batch_size=256, epochs=2, verbose=False)

    dense, fused = run(False), run(True)
    assert len(fused["loss"]) == 2 and fused["val_loss"] == []
    np.testing.assert_allclose(fused["loss"], dense["loss"], rtol=2e-2)


def test_fit_clamps_the_batch_and_holds_out_a_validation_split():
    _, _, tm, data = build_pair(num_examples=100, sparse_embed_grads=True)
    tt = Trainer(tm, learning_rate=1e-2, embedding_optimizer="fused_rowwise_adagrad",
                 device="cpu")
    hist = tt.fit(data, batch_size=4096, epochs=3, validation_split=0.2, verbose=False)
    assert tt.step == 3  # one clamped 80-row batch per epoch
    assert len(hist["loss"]) == len(hist["val_loss"]) == 3
    assert np.isfinite(hist["loss"] + hist["val_loss"]).all()
    with pytest.raises(ValueError, match="empty"):
        tt.fit({k: v[:0] for k, v in data.items()}, verbose=False)


# -- (g) evaluate_loss with a ragged tail --------------------------------------
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_evaluate_loss_matches_jax(compute):
    jm, params, tm, data = build_pair(compute, num_examples=300, seed=3)
    jt = JaxTrainer(jm)
    jt.init({k: v[:8] for k, v in data.items()})
    jt.state = jt.state.replace(params=params)
    want = jt.evaluate_loss(data, batch_size=128)  # 2 full batches + 44 rows
    got = Trainer(tm, device="cpu").evaluate_loss(data, batch_size=128)
    # a mean of per-example losses: the logits' tolerance carries over
    np.testing.assert_allclose(got, want, **TOL[compute])
