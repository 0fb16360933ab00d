"""The port's multi-rank measuring tools against the JAX package on the CPU:
the collective bytes each embedding engine moves (``tools/comm_bytes.py``,
counted at the port's collective calls, against the JAX tool's count of
the compiled HLO), the ids the a2a engine drops under skew
(``tools/skew_capacity.py``) and the data-parallel scaling harness
(``tools/scaling.py``).

The port's side runs in one spawned world of 4 gloo ranks for the module
(a (2, 2) mesh), and the scaling harness spawns its worlds of 1 and 2; the
JAX side runs in this process on ``jax.devices()[:4]``.  Inputs come from
numpy with a seed."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.parallel import embedding_sharding as jes
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.tools.comm_bytes import collective_bytes, engine_step_hlo
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools import comm_bytes, mesh_check, scaling, skew_capacity

SHAPE = (2, 2)
BATCH, VOCAB, D, FIELDS = 256, 1000, 16, 8
SKEW_BATCH = 256
A2A = ("a2a", "a2a_cf1.25", "a2a_dedup", "a2a_pipelined")


@pytest.fixture(scope="module")
def world4():
    table, ids = skew_capacity.inputs(SKEW_BATCH, VOCAB)
    jobs = [(comm_bytes.rank_counts, (SHAPE, BATCH, VOCAB, D, FIELDS), {}),
            # a bf16 table of twice the width: the same bytes a row
            (comm_bytes.rank_counts, (SHAPE, BATCH, VOCAB, 2 * D, FIELDS, "bfloat16"), {}),
            (skew_capacity.rank_drops, (SHAPE, table, ids), {})]
    foreign = []
    ranks = spawn(mesh_check.run_jobs, 4, jobs, foreign=foreign)
    assert foreign == [], f"a rank imported {foreign}"
    return ranks


@pytest.fixture(scope="module")
def jax_hlo():
    """{engine: the JAX tool's compiled HLO text} at the same inputs."""
    mesh = jax_make_mesh(data=SHAPE[0], model=SHAPE[1], devices=jax.devices()[:4])
    table, rows = comm_bytes.inputs(BATCH, VOCAB, D, FIELDS, SHAPE[1])
    t = jes.shard_table(jnp.asarray(table, jnp.float32), mesh)
    r = jnp.asarray(rows)
    return {e: engine_step_hlo(e, mesh, t, r) for e in comm_bytes.ENGINES}


def test_every_rank_counts_the_same(world4):
    for r in world4[1:]:
        assert r[0] == world4[0][0] and r[1] == world4[0][1] and r[2] == world4[0][2]


@pytest.mark.parametrize("engine", A2A)
def test_a2a_engines_move_the_jax_hlo_bytes(world4, jax_hlo, engine):
    """The three exchanges (ids out, vectors back, the vectors' gradient;
    two chunks of each pipelined): count and bytes equal to the JAX HLO's."""
    want = collective_bytes(jax_hlo[engine])
    assert world4[0][0]["engines"][engine] == want
    assert set(want) == {"all-to-all"}


@pytest.mark.parametrize("engine", ["psum", "dedup"])
def test_psum_engines_sum_once_where_jax_sums_twice(world4, jax_hlo, engine):
    """The port: one all-reduce of the (N_local, D) f32 partial lookup over
    the model axis (the dedup engine's N_local unique slots, padded to
    N_local).  JAX: the same all-reduce and a second one of the same bytes,
    its transpose, which sums the output's cotangent over the model axis.
    Every rank of that axis holds the same cotangent (the same loss of
    the same replicated output), so the port's ``AllReduceSum`` backward
    passes it on unsummed: a deliberate difference (ROADMAP)."""
    n_local = BATCH // SHAPE[0] * FIELDS
    one = n_local * D * 4
    assert world4[0][0]["engines"][engine] == {"all-reduce": {"count": 1, "bytes": one}}
    assert collective_bytes(jax_hlo[engine]) == {"all-reduce": {"count": 2, "bytes": 2 * one}}
    psums = [line for line in jax_hlo[engine].splitlines()
             if " all-reduce(" in line and "replica_groups={{0,1},{2,3}}" in line]
    assert len(psums) == 2 and sum("transpose(" in line for line in psums) == 1


def test_shard_gradient_sync_is_the_all_reduce_the_jax_count_misses(world4, jax_hlo):
    """The shard gradient's all-reduce over the data axis is the JAX
    HLO's ROOT instruction, which ``collective_bytes``'s pattern does not
    match: with the ROOT marker taken off, the JAX count gains exactly it."""
    sync = world4[0][0]["shard_grad_sync"]
    v_local = (VOCAB + (-VOCAB) % SHAPE[1]) // SHAPE[1]
    assert sync == {"all-reduce": {"count": 1, "bytes": v_local * D * 4}}
    for engine, hlo in jax_hlo.items():
        plain = collective_bytes(hlo)
        rooted = collective_bytes(hlo.replace("ROOT ", ""))
        extra = {k: {"count": rooted[k]["count"] - plain.get(k, {"count": 0})["count"],
                     "bytes": rooted[k]["bytes"] - plain.get(k, {"bytes": 0})["bytes"]}
                 for k in rooted}
        assert {k: e for k, e in extra.items() if e["count"]} == sync, engine


def test_tally_counts_the_logical_dtype_under_gloo(world4):
    """A bf16 table of width 2D moves the f32 table's bytes in every
    collective: gloo's staging (bf16 as float16 bits, or summed in f32)
    changes no count."""
    f32, bf16 = world4[0][0], world4[0][1]
    assert bf16["engines"] == f32["engines"]
    assert bf16["shard_grad_sync"]["all-reduce"]["bytes"] == \
        f32["shard_grad_sync"]["all-reduce"]["bytes"]


@pytest.fixture(scope="module")
def jax_drops():
    """{(dist, dedup, cf): the JAX engine's dropped ids} on the same ids."""
    table, ids = skew_capacity.inputs(SKEW_BATCH, VOCAB)
    mesh = jax_make_mesh(data=SHAPE[0], model=SHAPE[1], devices=jax.devices()[:4])
    t = jnp.asarray(table)
    out = {}
    for dedup in (False, True):
        for cf in skew_capacity.CAPACITY_FACTORS:
            # jitted: the JAX tool's eager calls take minutes on the virtual mesh
            fn = jax.jit(functools.partial(jes.sharded_gather_a2a, mesh=mesh, capacity_factor=cf,
                                           dedup=dedup, return_stats=True))
            for dist, arr in ids.items():
                out[dist, dedup, cf] = int(jnp.sum(fn(t, jnp.asarray(arr))[1]))
    return out


@pytest.mark.parametrize("dedup", [False, True], ids=["dedup0", "dedup1"])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_skew_capacity_drops_equal_jax(world4, jax_drops, dist, dedup):
    got = {(d, dd, cf): n for d, dd, cf, n in world4[0][2] if d == dist and dd == dedup}
    want = {k: v for k, v in jax_drops.items() if k[0] == dist and k[1] == dedup}
    assert got == want
    assert len(got) == len(skew_capacity.CAPACITY_FACTORS)


def test_skew_capacity_summary(world4):
    _, ids = skew_capacity.inputs(SKEW_BATCH, VOCAB)
    n = SKEW_BATCH * skew_capacity.FIELDS
    results, summary = skew_capacity.summarize(world4[0][2], ids, n)
    assert len(results) == 24 and all(r["dropped_frac"] == r["dropped"] / n for r in results)
    for key, cf in summary.items():
        dist, dedup = key.split("_")[0], key.split("_")[1] == "dedup1"
        rows = {r["cf"]: r["dropped"] for r in results
                if r["dist"] == dist and r["dedup"] == dedup}
        assert rows[cf] == 0 and all(d > 0 for c, d in rows.items() if c < cf)
    # zipf ids repeat: dedup needs no more capacity than uniform ids do
    assert summary["zipf_dedup1_min_zero_drop_cf"] <= summary["uniform_dedup1_min_zero_drop_cf"]


def test_comm_bytes_main_prints_one_report(capsys):
    rep = comm_bytes.main(["--device", "cpu", "--data", "1", "--model", "2", "--batch", "64",
                           "--vocab", "100", "--fields", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(rep))
    assert out["backend"] == "gloo" and set(out["engines"]) == set(comm_bytes.ENGINES)
    for e in out["engines"].values():
        assert e["total_bytes"] == sum(o["bytes"] for o in e["ops"].values())
        assert e["vs_psum"] == e["total_bytes"] / out["engines"]["psum"]["total_bytes"]
    # one data rank: 64 x 4 ids, a2a at cf 2 sends 2 x 256 ids and 2 x 256 vectors each way
    assert out["engines"]["a2a"]["total_bytes"] == 512 * 4 + 2 * 512 * 16 * 4


def test_scaling_reports_mechanics_of_gloo_worlds():
    rep = scaling.run(per_device_batch=64, steps=2, vocab=1000, device=torch.device("cpu"))
    assert rep["kind"] == "mechanics only" and rep["backend"] == "gloo"
    assert {"backend", "device_kind", "kind", "measured"} <= set(rep)
    assert [r["devices"] for r in rep["measured"]] == [1, 2]
    base = rep["measured"][0]["examples_per_s"]
    for r in rep["measured"]:
        assert np.isfinite(r["examples_per_s"]) and r["examples_per_s"] > 0
        assert r["scaling_efficiency"] == r["examples_per_s"] / (base * r["devices"])
        assert r["launches"] == {}  # the plain versions on the CPU

