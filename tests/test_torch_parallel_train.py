"""The port's multi-device training against the JAX package on the CPU:
kernels #4 and #5 in their multi-stream and model-shard forms (the plain
versions against the Pallas kernels in interpret mode), the native prep's
shard fences and the host-local streams, and ``Trainer`` on (data, model)
meshes under both data contracts: the fused and the sparse embedding
optimizers, the a2a engine, evaluation and prediction.

The port's ranks run in spawned gloo worlds of 2 and 4 (one spawn a world
for the module); the JAX Trainer runs in this process on a mesh of the same
shape over ``jax.devices()[:4]``.  The ranks import no JAX."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data import native as jax_native
from recsys_tpu.kernels.pallas.embedding_update_tpu import (fused_bwd_adam,
                                                            fused_bwd_rowwise_adagrad)
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel.mesh import shard_batch as jax_shard_batch
from recsys_tpu.parallel.mesh import shard_batch_local as jax_shard_batch_local
from recsys_tpu.parallel.sharding_rules import apply_param_shardings as jax_place
from recsys_tpu.train import sparse_embed as jax_sparse_embed
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu.train.streaming_embed import host_prep_group as jax_host_prep
from recsys_tpu.train.streaming_embed import make_host_prep as jax_make_host_prep
from recsys_tpu_torch.convert import embedding_state_from_jax, params_from_jax
from recsys_tpu_torch.data import native
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools import mesh_check as mc
from recsys_tpu_torch.train import sparse_embed, streaming_embed
from test_torch_dlrm import build_pair

P_TOL = dict(rtol=2e-4, atol=1e-7)  # tests/test_torch_embedding_update.py's
BF16_P_TOL = dict(rtol=8e-3, atol=1e-6)


# -- kernels #4 and #5: streams and the model-shard window --------------------
def _streams(rng, vocab, d, n, streams, block, ch, prep):
    """``streams`` sorted streams of n ids each, laid one after the other:
    (cot_sorted, ids2d, cptr)."""
    parts = []
    for _ in range(streams):
        ids = rng.integers(0, vocab, n).astype(np.int32)
        cot = (rng.standard_normal((n, d)) * 1e-2).astype(np.float32)
        i2, ix, cp = prep(ids, vp=vocab, block=block, ch=ch)
        parts.append((cot[ix], i2, cp))
    return tuple(np.concatenate(x) for x in zip(*parts))


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
@pytest.mark.parametrize("pdt", ["f32", "bf16"])
@pytest.mark.parametrize("streams", [1, 2, 4])
def test_plain_streams_match_pallas_interpret(streams, pdt, kind):
    vocab, d, n, block, ch = 256, 16, 96, 32, 32
    rng = np.random.default_rng(streams)
    cot, ids2d, cptr = _streams(rng, vocab, d, n, streams, block, ch,
                                functools.partial(jax_host_prep, pack=1, use_native=False))
    p = rng.uniform(-0.05, 0.05, (vocab, d)).astype(np.float32)
    m = (rng.standard_normal((vocab, d)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vocab, d)).astype(np.float32)
    acc = rng.uniform(0, 1e-4, vocab).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if pdt == "bf16" else (jnp.float32, torch.float32)
    kw = dict(block=block, ch=ch, pack=1, d=d, mm_bf16=True, interpret=True, streams=streams)
    jargs = (jnp.asarray(cot), jnp.asarray(ids2d), jnp.asarray(cptr))
    tp = torch.from_numpy(np.array(jnp.asarray(p, jdt).astype(jnp.float32))).to(tdt)
    targs = (torch.from_numpy(cot), torch.from_numpy(ids2d), torch.from_numpy(cptr))
    if kind == "adam":
        want = fused_bwd_adam(jnp.asarray(p, jdt), jnp.asarray(m), jnp.asarray(v), *jargs,
                              jnp.int32(3), lr=1e-3, **kw)
        got = (tp, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()))
        dispatch.fused_embedding_adam(*got, *targs, 3, block=block, lr=1e-3, streams=streams)
    else:
        want = fused_bwd_rowwise_adagrad(jnp.asarray(p, jdt), jnp.asarray(acc[:, None]), *jargs,
                                         1e-3, **kw)
        got = (tp, torch.from_numpy(acc.copy()))
        dispatch.fused_embedding_rowwise_adagrad(*got, *targs, block=block, lr=1e-3,
                                                 streams=streams)
    for name, g, w in zip("pmv" if kind == "adam" else "pa", got, want):
        w = np.asarray(w).astype(np.float32).reshape(g.shape)
        tol = BF16_P_TOL if name == "p" and pdt == "bf16" else \
            (dict(rtol=1e-3, atol=2e-7) if name == "p" and kind == "adagrad" else P_TOL)
        np.testing.assert_allclose(g.float().numpy(), w, **tol, err_msg=name)


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
@pytest.mark.parametrize("shards, streams", [(2, 1), (4, 1), (2, 2)])
def test_shard_window_equals_the_single_shard_update(shards, streams, kind):
    """Each shard's update of its rows, through its window of a prep with
    shard fences, equals the same rows of the whole table's update."""
    vocab, d, n, block, ch = 240, 8, 200, 16, 8
    rng = np.random.default_rng(shards + streams)
    ids = [rng.integers(0, vocab, n).astype(np.int32) for _ in range(streams)]
    cots = [(rng.standard_normal((n, d)) * 1e-2).astype(np.float32) for _ in range(streams)]
    p = rng.uniform(-0.05, 0.05, (vocab, d)).astype(np.float32)
    state = {"m": rng.standard_normal((vocab, d)).astype(np.float32) * 1e-3,
             "v": rng.uniform(1e-8, 1e-4, (vocab, d)).astype(np.float32),
             "acc": rng.uniform(0, 1e-4, vocab).astype(np.float32)}

    def run(rows, fences, shard_index, blk):
        lay = [streaming_embed.host_prep_group(i, vp=vocab, block=blk, ch=ch, shards=fences)
               for i in ids]
        cot = torch.from_numpy(np.concatenate([c[ix] for c, (_, ix, _) in zip(cots, lay)]))
        ids2d = torch.from_numpy(np.concatenate([x[0] for x in lay]))
        cptr = torch.from_numpy(np.concatenate([x[2] for x in lay]))
        t = torch.from_numpy(p[rows].copy())
        if kind == "adam":
            st = [torch.from_numpy(state[k][rows].copy()) for k in "mv"]
            dispatch.fused_embedding_adam(t, *st, cot, ids2d, cptr, 2, block=blk, lr=1e-3,
                                          mm_bf16=False, streams=streams,
                                          shard_index=shard_index)
        else:
            st = [torch.from_numpy(state["acc"][rows].copy())]
            dispatch.fused_embedding_rowwise_adagrad(
                t, *st, cot, ids2d, cptr, block=blk, lr=1e-3, mm_bf16=False, streams=streams,
                shard_index=shard_index)
        return [t.numpy(), *(x.numpy() for x in st)]

    whole = run(slice(None), 1, 0, block)
    vs = vocab // shards
    for s in range(shards):
        rows = slice(s * vs, (s + 1) * vs)
        got = run(rows, shards, s, min(block, vs))
        for g, w in zip(got, whole):
            np.testing.assert_allclose(g, w[rows], rtol=1e-6, atol=1e-9, err_msg=f"shard {s}")


def test_shard_window_refuses_a_window_past_the_pointers():
    t = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="window"):
        dispatch.fused_embedding_rowwise_adagrad(
            t, torch.zeros(8), torch.zeros(4, 2), torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), block=4, lr=1e-3, shard_index=1)


# -- the native prep's shard fences and the host-local streams ----------------
@pytest.mark.parametrize("shards", [1, 2, 4, 5])
@pytest.mark.parametrize("ch", [1, 8])
def test_prep_shard_fences_are_bit_equal_to_jax(shards, ch):
    rng = np.random.default_rng(shards * ch)
    vp, block = 1000, 96
    ids = rng.permutation(np.concatenate([rng.integers(0, vp, 400), np.full(300, 499),
                                          np.full(50, 500)])).astype(np.int32)
    got = native.fused_prep(ids, vp, block, ch, shards=shards)
    for want in (jax_native.fused_prep(ids, 1, vp, block, ch, shards=shards),
                 jax_host_prep(ids, pack=1, vp=vp, block=block, ch=ch, shards=shards,
                               use_native=False),
                 streaming_embed.host_prep_group(ids, vp=vp, block=block, ch=ch,
                                                 shards=shards)):
        for g, w, name in zip(got, want, ("ids2d", "idx", "cptr")):
            assert g.dtype == np.int32 and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    with pytest.raises(ValueError, match="divisible"):
        native.fused_prep(ids, vp, block, ch, shards=3)
    with pytest.raises(ValueError, match="divisible"):
        streaming_embed.host_prep_group(ids, vp=vp, block=block, ch=ch, shards=3)


def test_make_host_prep_streams_are_bit_equal_to_jax():
    """The local contract's streams as the port makes them, one
    ``make_host_prep(shards_by_name=)`` a data rank on its own rows (which
    ``apply_updates_fused`` all-gathers, one after the other), against the
    JAX host-local prep's (``data_shards=2``): ids and pointers equal, and
    the port's ``src`` the JAX ``idx``'s occurrence as its row of the
    rank's tap cotangent."""
    jm, params, tm, data = build_pair(vocab=64, num_sparse=4, num_examples=32)
    jplan = jax_sparse_embed.build_plan(params, jm.schema)
    plan = sparse_embed.build_plan(tm.embedding)
    shards = {name: 2 for name in plan.table_names}
    ch = 8
    want = jax_make_host_prep(jplan, block=16, ch=ch, shards_by_name=shards, data_shards=2)(
        data["sparse"])
    prep = streaming_embed.make_host_prep(plan, block=16, ch=ch, shards_by_name=shards)
    bs = len(data["sparse"]) // 2
    ranks = [prep(data["sparse"][d * bs:(d + 1) * bs]) for d in range(2)]
    f = data["sparse"].shape[1]
    for g, cols in enumerate(plan.group_cols):
        for d, got in enumerate(ranks):
            np.testing.assert_array_equal(got[f"embaux{g}_ids"], want[f"embaux{g}_ids"][d])
            np.testing.assert_array_equal(got[f"embaux{g}_ptr"], want[f"embaux{g}_ptr"][d])
            idx = want[f"embaux{g}_idx"][d]
            src = (idx % bs) * f + np.asarray(cols)[idx // bs]
            np.testing.assert_array_equal(got[f"embaux{g}_src"], src)


# -- Trainer on meshes ----------------------------------------------------------
STEPS, BATCH, LR = 3, 32, 1e-2
OPTS = ("fused_adam", "fused_rowwise_adagrad")
CONTRACTS = ("global", "local")


@pytest.fixture(scope="module")
def setup():
    jm, params, tm, data = build_pair(vocab=64, num_examples=STEPS * BATCH,
                                      sparse_embed_grads=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    model_fn = functools.partial(mc.dlrm, tm.schema, bottom_units=(16, 8), top_units=(32, 16),
                                 sparse_embed_grads=True)
    batches = [{k: v[s * BATCH:(s + 1) * BATCH] for k, v in data.items()}
               for s in range(STEPS)]
    schema, fit_data = synthetic_ctr(num_examples=256, num_dense=3, num_sparse=4,
                                     vocab_size=64, embed_dim=4, seed=5)
    torch.manual_seed(0)
    small = functools.partial(mc.dlrm, schema, bottom_units=(8, 4), top_units=(8,))
    g1 = functools.partial(small, embed_kw={"num_groups": 1})
    return {"jm": jm, "params": params, "tm": tm, "state": state, "model_fn": model_fn,
            "batches": batches, "fit_data": fit_data,
            "sparse_fn": functools.partial(small, sparse_embed_grads=True),
            "sparse_state": {k: v.numpy() for k, v in small(sparse_embed_grads=True)
                             .state_dict().items()},
            "g1_state": {k: v.numpy() for k, v in g1().state_dict().items()},
            "a2a_fn": functools.partial(small, embed_kw={"num_groups": 1, "engine": "a2a",
                                                         "capacity_factor": None}),
            "gather_fn": functools.partial(small, embed_mesh=True, embed_kw={"num_groups": 1}),
            "tight_fn": functools.partial(small, embed_kw={
                "num_groups": 1, "engine": "a2a", "capacity_factor": 0.4, "a2a_dedup": False})}


def _tkw(opt):
    return {"embedding_optimizer": opt, "embedding_fused_bf16": False, "learning_rate": LR}


FIT = {"batch_size": 64, "epochs": 2}


def _step_jobs(setup, shapes):
    return [(mc.train_steps, (shape, setup["model_fn"], setup["state"], setup["batches"],
                              contract, _tkw(opt)), {})
            for shape in shapes for contract in CONTRACTS for opt in OPTS]


def _spawn(world, jobs):
    foreign = []
    res = spawn(mc.run_jobs, world, jobs, foreign=foreign)
    assert foreign == [], f"a rank imported {foreign}"
    return res


@pytest.fixture(scope="module")
def world2(setup):
    return _spawn(2, _step_jobs(setup, [(2, 1), (1, 2)]))


@pytest.fixture(scope="module")
def world4(setup):
    zeros = dict(setup["fit_data"], sparse=np.zeros_like(setup["fit_data"]["sparse"]))
    jobs = _step_jobs(setup, [(2, 2)]) + [
        (mc.fit, ((2, 2), setup["sparse_fn"], setup["sparse_state"], setup["fit_data"], FIT),
         {"trainer_kw": {"embedding_optimizer": "rowwise_adagrad", "learning_rate": LR}}),
        (mc.fit, ((2, 2), setup["sparse_fn"], setup["sparse_state"], setup["fit_data"], FIT),
         {"trainer_kw": _tkw("fused_adam"), "contract": "local", "predict": False,
          "eval_batch": 48}),
        (mc.fit, ((2, 2), setup["a2a_fn"], setup["g1_state"], setup["fit_data"], FIT),
         {"trainer_kw": {"learning_rate": LR}}),
        (mc.fit, ((2, 2), setup["gather_fn"], setup["g1_state"], setup["fit_data"], FIT),
         {"trainer_kw": {"learning_rate": LR}}),
        (mc.fit, ((2, 2), setup["tight_fn"], None, zeros, {"batch_size": 64, "epochs": 1}),
         {"trainer_kw": {"learning_rate": LR}, "predict": False}),
    ]
    return _spawn(4, jobs)


def _steps(world2, world4, shape, contract, opt):
    world, shapes = (world4, [(2, 2)]) if shape == (2, 2) else (world2, [(2, 1), (1, 2)])
    i = (shapes.index(shape) * len(CONTRACTS) + CONTRACTS.index(contract)) * len(OPTS) + \
        OPTS.index(opt)
    ranks = [r[i] for r in world]
    for r in ranks[1:]:  # every rank holds the same whole state and losses
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k], err_msg=k)
    return ranks[0]


@pytest.fixture(scope="module")
def one_process(setup):
    return {opt: mc.train_steps(None, setup["model_fn"], setup["state"], setup["batches"],
                                trainer_kw=_tkw(opt)) for opt in OPTS}


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_fused_steps_on_a_mesh_match_one_process(world2, world4, one_process, shape,
                                                 contract, opt):
    got, want = _steps(world2, world4, shape, contract, opt), one_process[opt]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-5)
    for k, w in want["state"].items():
        np.testing.assert_allclose(got["state"][k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_local_contract_matches_global(world2, world4):
    """The bound of tests/test_multihost.py: f32 sums in another order
    across the data ranks' streams."""
    for shape in ((2, 1), (1, 2), (2, 2)):
        for opt in OPTS:
            g = _steps(world2, world4, shape, "global", opt)
            loc = _steps(world2, world4, shape, "local", opt)
            np.testing.assert_allclose(loc["losses"], g["losses"], rtol=2e-5, atol=2e-5)
            for k, w in g["state"].items():
                np.testing.assert_allclose(loc["state"][k], w, rtol=2e-5, atol=2e-5,
                                           err_msg=f"{shape} {opt} {k}")


# the JAX Trainer on its (2, 2) mesh, three steps from the same weights
JAX_CASES = [("global", "fused_adam"), ("local", "fused_adam"),
             ("global", "fused_rowwise_adagrad")]


def _jax_steps(setup, contract, opt):
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jt = JaxTrainer(setup["jm"], learning_rate=LR, embedding_optimizer=opt,
                    embedding_fused_bf16=False, mesh=mesh, data_contract=contract)
    jt.init({k: v[:BATCH] for k, v in setup["batches"][0].items()})
    fresh = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), setup["params"])
    jt.state = jt.state.replace(params=jax_place(fresh, mesh))
    jt._build_steps()
    put = jax_shard_batch_local if contract == "local" else jax_shard_batch
    losses = []
    for s, batch in enumerate(setup["batches"]):
        b = dict(batch, **jt._streaming_prep(batch["sparse"]))
        jt.state, loss, _ = jt._train_step(jt.state, put(b, mesh), jax.random.PRNGKey(s))
        losses.append(float(loss))
    tm = setup["tm"]
    state = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.params), tm.schema, tm).items()}
    emb = embedding_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.opt_state["emb"]),
                                   tm.schema, tm)
    state.update({f"emb_state.{n}.{k}": v.numpy() for n, st in emb.items() for k, v in st.items()})
    return losses, state


@pytest.mark.parametrize("contract, opt", JAX_CASES)
def test_fused_steps_match_the_jax_trainer_on_its_mesh(setup, world2, world4, contract, opt):
    want_losses, want = _jax_steps(setup, contract, opt)
    got = _steps(world2, world4, (2, 2), contract, opt)
    # the losses within 1e-5 (tests/test_torch_dlrm.py's f32 logits); the
    # weights as tests/test_torch_training.py holds three steps: every cell
    # within 2·lr·steps, and a cell past 1e-5 only where a gradient within
    # the rounding noise of zero moved it the other way (at most 1e-3 of them)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-5)
    for k, w in want.items():
        diff = np.abs(got["state"][k].astype(np.float64) - w)
        if k.startswith("emb_state."):  # f32 sums in another order
            np.testing.assert_allclose(got["state"][k], w, rtol=1e-4, atol=1e-9, err_msg=k)
            continue
        assert diff.max() <= 2 * LR * STEPS * 1.001, (k, diff.max())
        assert (diff > 1e-5).mean() <= 1e-3, k


def test_rowwise_adagrad_on_a_mesh_predicts_as_one_process(setup, world4):
    """tests/test_sparse_embed.py's bound: two epochs of fit on (2, 2)
    against no mesh, predictions within 2e-4; the loss and the AUC of the
    same weights agree too."""
    got = world4[0][len(CONTRACTS) * len(OPTS)]
    want = mc.fit(None, setup["sparse_fn"], setup["sparse_state"], setup["fit_data"], FIT,
                  trainer_kw={"embedding_optimizer": "rowwise_adagrad", "learning_rate": LR})
    np.testing.assert_allclose(got["predict"], want["predict"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=1e-5)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 and abs(got["auc"] - want["auc"]) <= 1e-3
    assert got["history"]["loss"][-1] < got["history"]["loss"][0]
    for r in world4[1:]:
        np.testing.assert_array_equal(r[len(CONTRACTS) * len(OPTS)]["predict"], got["predict"])


def test_local_contract_fit_evaluates_as_one_process(setup, world4):
    """Each rank fits on its data shard's rows (its own shuffle, so other
    batches than one process's); its evaluate_loss and evaluate_auc over
    every rank's rows, in batches of 48 with a ragged tail (24 rows a rank),
    equal one process's evaluation of the same weights."""
    from recsys_tpu_torch.train.loop import Trainer

    loc = world4[0][len(CONTRACTS) * len(OPTS) + 1]
    assert loc["history"]["loss"][-1] < loc["history"]["loss"][0]
    model = setup["sparse_fn"](None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in loc["state"].items()
                           if not k.startswith(("emb_state.", "exp_avg."))})
    tr = Trainer(model, device="cpu")
    assert abs(loc["loss"] - tr.evaluate_loss(setup["fit_data"], 48)) <= 1e-5
    assert abs(loc["auc"] - tr.evaluate_auc(setup["fit_data"], 48)) <= 1e-4


def test_a2a_engine_fit_matches_the_gather_engine_and_reports_drops(world4):
    """tests/test_parallel.py's DLRM through the a2a engine in exact mode:
    the loss of each epoch as the gather engine's on the same mesh, no id
    dropped; a tight capacity on skewed ids drops ids, counted."""
    i = len(CONTRACTS) * len(OPTS)
    a2a, gather, tight = world4[0][i + 2], world4[0][i + 3], world4[0][i + 4]
    np.testing.assert_allclose(a2a["history"]["loss"], gather["history"]["loss"], rtol=1e-6)
    assert a2a["history"]["a2a_dropped"] == [0, 0]
    assert "a2a_dropped" not in gather["history"]
    np.testing.assert_allclose(a2a["predict"], gather["predict"], rtol=0, atol=1e-5)
    assert tight["history"]["a2a_dropped"][0] > 0
    assert np.isfinite(tight["history"]["loss"][0])
