"""The port's multi-device layer against the JAX package on the CPU: the
mesh, the sharding rules and init into shards, the sharded embedding
engines (lookups and gradients), capacity overflow, top-k over a sharded
catalog and sharded checkpoints.

The port's side runs in worlds of 2 and 4 spawned gloo ranks (one spawn
a world for the module: every case of that world runs in it and returns
its results); the JAX side runs in this process on meshes of the same
shape over ``jax.devices()[:n]``.  The ranks import no JAX, which each
fixture checks.  Inputs come from numpy with a seed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.parallel import embedding_sharding as jes
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.train.retrieval import topk_scores as jax_topk
from recsys_tpu.train.retrieval import topk_scores_sharded as jax_topk_sharded
from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools import mesh_check as mc

V, D, B, F = 64, 8, 8, 6  # table rows and width; batch rows and ids a row


def _inputs(seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    rows = rng.integers(0, V, (B, F)).astype(np.int64)
    weights = rng.normal(size=(B, F, D)).astype(np.float32)
    return table, rows, weights


def _skewed():
    """Every id owned by the first shard; each data shard's 2 rows x 6 ids
    overflow a capacity of ceil(12 / 2 x 1.0) = 6 by 6 on a (2, 2) mesh."""
    table = np.arange(V * 4, dtype=np.float32).reshape(V, 4)
    return table, np.full((B, F), 3, np.int64), np.ones((B, F, 4), np.float32)


def _padded():
    table, rows, weights = _inputs(13)
    rows[:, -2:] = -1
    return table, rows, weights


ENGINE_CASES = [
    ("psum", "psum", {}),
    ("dedup", "dedup", {}),
    ("a2a", "a2a", {"capacity_factor": 2.0, "return_stats": True}),
    ("a2a-dedup", "a2a", {"capacity_factor": 2.0, "dedup": True, "return_stats": True}),
    ("a2a-exact", "a2a", {"capacity_factor": None, "return_stats": True}),
    ("a2a_pipelined-2", "a2a_pipelined", {"num_chunks": 2, "return_stats": True}),
    ("a2a_pipelined-3-dedup", "a2a_pipelined",
     {"num_chunks": 3, "dedup": True, "return_stats": True}),
    ("cols", "cols", {}),
]
OVERFLOW_CASES = [
    ("tight", "a2a", {"capacity_factor": 1.0, "return_stats": True}),
    ("exact", "a2a", {"capacity_factor": None, "return_stats": True}),
    ("pipelined-tight", "a2a_pipelined",
     {"num_chunks": 2, "capacity_factor": 1.0, "return_stats": True}),
]
PAD_CASES = [("a2a", "a2a", {"return_stats": True}), ("psum", "psum", {})]
# the third table's 63 rows the model axis does not divide
SCHEMA = FeatureSchema(dense=[DenseFeature(f"I{i}") for i in range(3)],
                       sparse=[SparseFeature(f"C{i}", v, 4) for i, v in enumerate((64, 64, 63))])
MODEL_FN = functools.partial(mc.dlrm, SCHEMA, embed_mesh=True, bottom_units=(8, 4),
                             top_units=(8,))
TOPK = dict(k=5)


def _topk_inputs():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    items = rng.normal(size=(50, 16)).astype(np.float32)
    items[30] = items[3]  # equal scores: the lower id ranks first
    return q, items


def _world_jobs(shapes):
    jobs = []
    for shape in shapes:
        jobs.append((mc.lookups, (shape, *_inputs(sum(shape)), ENGINE_CASES), {}))
        jobs.append((mc.topk, (shape, *_topk_inputs(), TOPK["k"]), {}))
        jobs.append((mc.mesh_facts, (shape, MODEL_FN), {}))
    return jobs


def _spawn(world, jobs):
    foreign = []
    res = spawn(mc.run_jobs, world, jobs, foreign=foreign)
    assert foreign == [], f"a rank imported {foreign}"
    return res


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt2")
    jobs = _world_jobs([(2, 1), (1, 2)])
    data = synthetic_ctr(num_examples=16, num_dense=3, num_sparse=3, vocab_size=63,
                         embed_dim=4, seed=1)[1]
    batches = [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()} for i in range(2)]
    model_fn = functools.partial(MODEL_FN, sparse_embed_grads=True)
    jobs.append((mc.checkpoint, ((1, 2), (2, 1), str(tmp / "ckpt"), model_fn, batches),
                 {"trainer_kw": {"embedding_optimizer": "fused_adam"}}))
    return {"shapes": {(2, 1): 0, (1, 2): 3}, "results": _spawn(2, jobs)}


@pytest.fixture(scope="module")
def world4():
    jobs = _world_jobs([(2, 2)])
    jobs.append((mc.lookups, ((2, 2), *_skewed(), OVERFLOW_CASES), {}))
    jobs.append((mc.lookups, ((2, 2), *_padded(), PAD_CASES), {}))
    return {"shapes": {(2, 2): 0}, "results": _spawn(4, jobs)}


def _job(worlds, shape, offset):
    w = worlds[0] if shape in worlds[0]["shapes"] else worlds[1]
    i = w["shapes"][shape] + offset
    return [r[i] for r in w["results"]]


@pytest.fixture(scope="module")
def worlds(world2, world4):
    return (world2, world4)


def _jax_engine(name, kw, table, rows, weights, shape):
    mesh = jax_make_mesh(data=shape[0], model=shape[1], devices=jax.devices()[:shape[0] * shape[1]])
    fn = {"psum": jes.sharded_gather, "dedup": jes.sharded_gather_dedup,
          "a2a": jes.sharded_gather_a2a, "a2a_pipelined": jes.sharded_gather_a2a_pipelined,
          "cols": jes.sharded_gather_cols}[name]
    put = jes.shard_table_cols if name == "cols" else jes.shard_table
    t = put(jnp.asarray(table), mesh)
    r, w = jnp.asarray(rows, jnp.int32), jnp.asarray(weights)

    def loss(tab):
        res = fn(tab, r, mesh, **kw)
        out = res[0] if isinstance(res, tuple) else res
        return jnp.sum(out * w), res

    (_, res), grad = jax.value_and_grad(loss, has_aux=True)(t)
    out, dropped = res if isinstance(res, tuple) else (res, None)
    return np.asarray(out), np.asarray(grad), None if dropped is None else int(dropped)


def _scatter_add(rows, weights, shape):
    g = np.zeros(shape, np.float64)
    ok = rows >= 0
    np.add.at(g, rows[ok], weights[ok])
    return g


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_engine_lookups_and_gradients_match_take_and_scatter_add(worlds, shape):
    table, rows, weights = _inputs(sum(shape))
    ranks = _job(worlds, shape, 0)
    want_out = table[rows]
    want_grad = _scatter_add(rows, weights, table.shape)
    for label, engine, kw in ENGINE_CASES:
        out, grad, dropped = ranks[0][label]
        for r in ranks[1:]:  # every rank returns the same whole result
            np.testing.assert_array_equal(r[label][0], out, err_msg=label)
            np.testing.assert_array_equal(r[label][1], grad, err_msg=label)
        np.testing.assert_array_equal(out, want_out, err_msg=label)
        # a sum of the same terms in another order; no factor of the model axis
        np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6, err_msg=label)
        assert dropped in (None, 0), label


# The JAX engines at (2, 2), where both packages shard over both axes.  An
# a2a engine under jax.grad takes the JAX package 15-30 s to compile on the
# virtual CPU mesh, so the JAX a2a engine runs once, on the overflow case;
# the port's a2a engines are held against the JAX psum engine's gradient
# (the same scatter-add) and against take.
JAX_CASES = ("psum", "dedup", "cols")


@pytest.fixture(scope="module")
def jax_engines():
    table, rows, weights = _inputs(4)
    cases = {label: (engine, kw) for label, engine, kw in ENGINE_CASES}
    out = {label: _jax_engine(*cases[label], table, rows, weights, (2, 2))
           for label in JAX_CASES}
    sk = _skewed()
    out["tight"] = _jax_engine("a2a", OVERFLOW_CASES[0][2], *sk, (2, 2))
    return out


def test_engines_match_jax(worlds, jax_engines):
    ranks = _job(worlds, (2, 2), 0)
    for label in JAX_CASES:
        out, grad, dropped = ranks[0][label]
        j_out, j_grad, j_dropped = jax_engines[label]
        np.testing.assert_array_equal(out, j_out, err_msg=label)
        np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-6, err_msg=label)
        assert dropped == j_dropped, label
    for label in ("a2a", "a2a-dedup", "a2a-exact", "a2a_pipelined-2",
                  "a2a_pipelined-3-dedup"):
        np.testing.assert_array_equal(ranks[0][label][0], jax_engines["psum"][0], err_msg=label)
        np.testing.assert_allclose(ranks[0][label][1], jax_engines["psum"][1], rtol=0,
                                   atol=1e-6, err_msg=label)


def test_a2a_overflow_is_counted_and_exact_mode_drops_nothing(worlds, jax_engines):
    table, rows, weights = _skewed()
    out, grad, dropped = _job(worlds, (2, 2), 3)[0]["tight"]
    j_out, j_grad, j_dropped = jax_engines["tight"]
    assert dropped == j_dropped == 2 * 12  # each data shard's 4 x 6 ids, capacity 12
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-6)
    assert int((out == 0).all(-1).sum()) == 2 * 12  # dropped ids read as zero vectors
    res = _job(worlds, (2, 2), 3)[0]
    assert res["exact"][2] == 0
    np.testing.assert_array_equal(res["exact"][0], table[rows])
    # per-chunk capacity: each chunk of 12 ids has 6 slots a owner
    assert res["pipelined-tight"][2] == 2 * 12


def test_negative_ids_are_padding(worlds):
    table, rows, weights = _padded()
    ranks = _job(worlds, (2, 2), 4)
    want = table[np.clip(rows, 0, V - 1)]
    want[rows < 0] = 0.0
    for label, engine, kw in PAD_CASES:
        out, grad, dropped = ranks[0][label]
        np.testing.assert_array_equal(out, want, err_msg=label)
        np.testing.assert_allclose(grad, _scatter_add(rows, weights, table.shape), rtol=0,
                                   atol=1e-6, err_msg=label)
        assert dropped in (None, 0)


def test_unique_with_counts_static_matches_jax():
    for ids in (np.array([5, 3, 5, 7, 3, 3, 9, 5]), np.random.default_rng(4).integers(
            -1, 20, 64), np.zeros(1, np.int64)):
        got = mc.unique_static(ids.astype(np.int64))
        want = jes.unique_with_counts_static(jnp.asarray(ids, jnp.int32))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got[0][got[1]], ids)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_topk_sharded_matches_jax_and_dense(worlds, shape):
    q, items = _topk_inputs()
    ranks = _job(worlds, shape, 1)
    dv, di = jax_topk(jnp.asarray(q), jnp.asarray(items), k=TOPK["k"])
    mesh = jax_make_mesh(data=shape[0], model=shape[1],
                         devices=jax.devices()[:shape[0] * shape[1]])
    sv, si = jax_topk_sharded(mesh, jnp.asarray(q), jnp.asarray(items), k=TOPK["k"])
    for v, i, launches in ranks:
        assert launches == 0  # the CPU takes the plain top-k
        np.testing.assert_allclose(v, np.asarray(dv), rtol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(di))
        np.testing.assert_allclose(v, np.asarray(sv), rtol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(si))
    assert (ranks[0][1] == 3).any() and not (ranks[0][1] == 30).any()  # the tie's lower id


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_mesh_layout_sharding_rules_and_init_into_shards(worlds, shape):
    ranks = _job(worlds, shape, 2)
    data, model = shape
    # the same init built with no mesh
    torch.manual_seed(0)
    whole = {k: v.numpy() for k, v in MODEL_FN(None).state_dict().items()
             if k.startswith("embedding.table_")}
    for r, facts in enumerate(ranks):
        assert facts["coords"] == (r // model, r % model)
        assert facts["ranks"]["model"] == [r // model * model + m for m in range(model)]
        assert facts["ranks"]["data"] == [d * model + r % model for d in range(data)]
        rules = facts["shardings"]
        split = "model" if model > 1 else None
        assert rules["embedding.table_0"] == rules["embedding.table_1"] == split
        assert rules["embedding.table_2"] is None  # 63 rows do not split
        assert all(v is None for k, v in rules.items() if not k.startswith("embedding."))
        assert facts["table_shards"] == ({0: model, 1: model} if model > 1 else {})
        for name, t in facts["tables"].items():  # a shard is its rows of the whole init
            np.testing.assert_array_equal(t, whole[name], err_msg=name)
        assert "!= " in facts["errors"]["make_mesh"]
        assert "local contract" in facts["errors"]["predict"]


def test_sharded_checkpoint_round_trip_and_changed_mesh(world2):
    ranks = [r[-1] for r in world2["results"]]
    for res in ranks:
        assert res["equal"], "restored state is not bit-equal"
        assert res["next_loss_equal"]
        assert res["table_share"] == 0.5  # no block holds a whole sharded table
        assert res["refused"] is not None and "mesh or model changed" in res["refused"]


class _Mesh:
    """The part of a mesh shard_batch reads, for data rank ``d`` of ``n``."""

    def __init__(self, n, d):
        self.n, self.d = n, d

    def size(self, axis):
        return self.n

    def index(self, axis):
        return self.d


def test_shard_batch_keeps_this_ranks_rows_and_the_prep():
    batch = {"sparse": np.arange(8 * 3).reshape(8, 3), "label": np.arange(8.0),
             "embaux0_ids": np.zeros((5, 2)), "embaux0_src": np.arange(10),
             "embaux0_ptr": np.arange(3)}
    got = shard_batch(batch, _Mesh(2, 1))
    np.testing.assert_array_equal(got["sparse"], batch["sparse"][4:])
    np.testing.assert_array_equal(got["label"], batch["label"][4:])
    for k in ("embaux0_ids", "embaux0_src", "embaux0_ptr"):  # global prep: whole
        assert got[k] is batch[k]
    assert shard_batch(batch, None) == batch
    with pytest.raises(ValueError, match="split"):
        shard_batch({"label": np.arange(7.0)}, _Mesh(2, 0))
    assert [pad_to_multiple(n, 4) for n in (0, 1, 4, 5)] == [0, 4, 4, 8]
