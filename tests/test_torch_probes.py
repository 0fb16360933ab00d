"""The port's probes slice against the JAX package on the CPU.

* The plain versions of the three probe kernels (``kernels/probes.py``)
  against the JAX package's Pallas kernels run in interpret mode, the Adam
  pass (``dispatch.adam_stream_pass_``) table by table:
  ``_pallas_adam_kernel`` within rtol 1e-6, atol 1e-9 (XLA may contract a
  multiply and an add into one rounding); ``_perrow_kernel`` and
  ``hot_gather_pallas(mm_bf16=False)`` bit for bit; the JAX default
  ``mm_bf16=True`` within one bf16 rounding of the exact rows.
* ``host_split``, ``_zipf_ids``, ``zipf_ids`` and ``seed_stats`` against
  their JAX counterparts: equal.
* The probes' CLIs on the CPU at tiny sizes, ``probe_check``'s limits
  rejecting its wrong results, the Adam pass's refusals and the per-row
  walk's geometry (``dispatch.perrow_plan``).
"""
import functools
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import probe_check
from recsys_tpu.tools import dedup_probe as jax_dedup
from recsys_tpu.tools import gather_split_probe as jax_split
from recsys_tpu.tools import seed_stats as jax_seed_stats
from recsys_tpu.tools.stream_probe import _pallas_adam_kernel, _perrow_kernel
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import probes
from recsys_tpu_torch.tools import dedup_probe, gather_split_probe, seed_stats, stream_probe

ADAM_TOL = dict(rtol=1e-6, atol=1e-9)


# -- #11: the elementwise Adam stream -------------------------------------------
def _jax_adam(p, m, v, g, block=16):
    """The JAX probe's pallas_call of ``_pallas_adam_kernel`` (blocks of
    ``block`` rows, in place through input_output_aliases), in interpret
    mode."""
    blk = pl.BlockSpec((block, p.shape[1]), lambda i: (i, 0), memory_space=pltpu.VMEM)
    kern = functools.partial(_pallas_adam_kernel, b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    return pl.pallas_call(
        kern, grid=(pl.cdiv(p.shape[0], block),), in_specs=[blk] * 4, out_specs=(blk,) * 3,
        out_shape=(jax.ShapeDtypeStruct(p.shape, p.dtype),) * 3,
        input_output_aliases={0: 0, 1: 1, 2: 2}, interpret=True,
    )(*(jnp.asarray(a) for a in (p, m, v, g)))


@pytest.mark.parametrize("state", ["probe", "random"])
def test_adam_stream_plain_matches_pallas_kernel(state):
    """(40, 128) in blocks of 16 rows: the last block is ragged."""
    arrays = [a.reshape(40, 128) for a in
              probe_check.adam_inputs(np.random.default_rng(0), 40 * 128, state)]
    want = _jax_adam(*arrays)
    p, m, v, g = (torch.from_numpy(a.copy()) for a in arrays)
    g_before = g.clone()
    probes.adam_stream_step_(p, m, v, g)
    for got, w, name in zip((p, m, v), want, "pmv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **ADAM_TOL, err_msg=name)
    assert torch.equal(g, g_before)
    assert not np.array_equal(p.numpy(), arrays[0])


def test_adam_stream_wrapper_runs_the_plain_step_on_cpu_in_place():
    arrays = probe_check.adam_inputs(np.random.default_rng(1), 1001, "random")
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    want = [torch.from_numpy(a.copy()) for a in arrays]
    probes.adam_stream_step_(*want)
    dispatch.reset_launches()
    assert dispatch.adam_stream_step_(*ts) is None
    assert dispatch.LAUNCHES["adam_stream"] == 0  # the plain version launches nothing
    for got, w in zip(ts, want):
        assert probe_check.bits_equal(got, w)
    with pytest.raises(ValueError, match="f32 of one shape"):
        dispatch.adam_stream_step_(ts[0], ts[1], ts[2], ts[3].double())


def _pass_tables(state):
    """Three tables of unequal sizes: (40, 128); a ragged (37, 16), its last
    block of 16 rows short; a (9, 33) view one element into its storage."""
    rng = np.random.default_rng(2)
    tables = []
    for rows, cols, offset in ((40, 128, 0), (37, 16, 0), (9, 33, 1)):
        flat = probe_check.adam_inputs(rng, rows * cols + offset, state)
        tables.append(([a[offset:].reshape(rows, cols) for a in flat],
                       [torch.from_numpy(a.copy())[offset:].view(rows, cols) for a in flat]))
    return tables


@pytest.mark.parametrize("state", ["probe", "random"])
def test_adam_stream_pass_matches_pallas_kernel_per_table(state):
    tables = _pass_tables(state)
    plain = [[t.clone() for t in ts] for _, ts in tables]
    gs = [ts[3].clone() for _, ts in tables]
    dispatch.reset_launches()
    assert dispatch.adam_stream_pass_(*(list(q) for q in zip(*(ts for _, ts in tables)))) is None
    assert dispatch.LAUNCHES["adam_stream"] == 0  # the plain version launches nothing
    for (arrays, ts), want, g in zip(tables, plain, gs):
        assert ts[0].storage_offset() in (0, 1)
        for got, w, name in zip(ts[:3], _jax_adam(*arrays), "pmv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **ADAM_TOL, err_msg=name)
        probes.adam_stream_step_(*want)
        for got, w in zip(ts, want):
            assert probe_check.bits_equal(got, w)
        assert torch.equal(ts[3], g)


@pytest.mark.parametrize("fault", ["unequal lists", "f64 g", "shape mismatch",
                                   "cpu table then meta table", "meta table then cpu table",
                                   "meta g in a cpu table"])
def test_adam_stream_pass_refuses_what_it_cannot_take(fault):
    ts = [[torch.ones(8) for _ in range(2)] for _ in range(4)]
    if fault == "unequal lists":
        ts[2] = ts[2][:1]
        match = "one length"
    elif fault in ("f64 g", "shape mismatch"):
        ts[3][1] = torch.zeros(8, dtype=torch.float64) if fault == "f64 g" else torch.zeros(9)
        match = "f32 of one shape"
    else:  # no table may be stepped on a device other than the first table's
        meta = 0 if fault == "meta table then cpu table" else 1
        for lst in ts[3:] if fault == "meta g in a cpu table" else ts:
            lst[meta] = torch.ones(8, device="meta")
        match = "every tensor must be on"
    before = [t.clone() for lst in ts for t in lst if t.device.type == "cpu"]
    with pytest.raises(ValueError, match=match):
        dispatch.adam_stream_pass_(*ts)
    after = [t for lst in ts for t in lst if t.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(after, before))  # nothing stepped


# -- #12: the per-row walk ------------------------------------------------------
def _jax_perrow(x):
    return pl.pallas_call(
        _perrow_kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, x.shape[1]), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, x.shape[1]), jnp.float32)], interpret=True,
    )(jnp.asarray(x))


@pytest.mark.parametrize("n", [64, 257])
def test_perrow_colsum_plain_is_bit_equal_to_pallas_kernel(n):
    x = (np.random.default_rng(n).standard_normal((n, 128)) * 10).astype(np.float32)
    got = dispatch.perrow_colsum(torch.from_numpy(x))
    want = torch.from_numpy(np.array(_jax_perrow(x)))
    assert probe_check.bits_equal(got, want)


@pytest.mark.parametrize("n", [1, 777, 8192, 100_000])
@pytest.mark.parametrize("w", [1, 3, 4, 128, 130, 1024])
def test_perrow_plan_covers_every_column_once_within_shared_memory(n, w):
    plan = dispatch.perrow_plan(n, w)
    cols, blocks = plan["cols"], plan["blocks"]
    owners = [c // cols for c in range(w)]  # block b owns columns [b·cols, b·cols + cols)
    assert sorted(set(owners)) == list(range(blocks))  # no block without a column
    assert plan["smem_bytes"] <= 232_448  # the H100's opt-in shared memory a block
    pitch = plan["pitch"]  # a column's floats in a stage: whole 16-byte loads, and 4 more
    assert pitch % 4 == 0 and plan["chunk_rows"] + 4 <= pitch < plan["chunk_rows"] + 8
    assert plan["smem_bytes"] == 16 * plan["stages"] + 4 * plan["stages"] * cols * pitch
    assert 1 <= plan["chunk_rows"] <= n and plan["stages"] >= 1
    assert plan["chunk_rows"] % 64 == 0 or plan["chunk_rows"] == n  # whole 64-row groups
    assert plan["stages"] * plan["chunk_rows"] < n + plan["chunk_rows"]  # no empty stage
    if (n, w) == (8192, 128):
        assert blocks > 1


# -- #13: the hot gather ----------------------------------------------------------
def _hot_case(pack, hot_n=128, n=2048):
    """The JAX test's ids (tests/test_pallas_kernels.py): Zipf(1.1) ids from
    seed 3, split at ``hot_n`` rows; a (vp, 128) table from seed 0."""
    ids = jax_split._zipf_ids(np.random.default_rng(3), 1.1, n)
    split = gather_split_probe.host_split(ids, hot_n, pack)
    d = jax_split.D
    table = np.random.default_rng(0).uniform(-0.05, 0.05, (jax_split.VOCAB // pack + 8,
                                                           pack * d)).astype(np.float32)
    return table[split[0]], split


@pytest.mark.parametrize("pack", [8, 1])
def test_hot_gather_plain_is_bit_equal_to_pallas_kernel(pack):
    hot_buf, (_, hot_idx2d, _, _, n_hot, _) = _hot_case(pack)
    want = np.array(jax_split.hot_gather_pallas(
        jnp.asarray(hot_buf), jnp.asarray(hot_idx2d), pack=pack, d=jax_split.D,
        mm_bf16=False, interpret=True))
    got = dispatch.hot_gather(torch.from_numpy(hot_buf), torch.from_numpy(hot_idx2d), pack)
    assert got.shape == want.shape
    assert probe_check.bits_equal(got, torch.from_numpy(want))
    assert n_hot % jax_split.CH and not got[n_hot:].any()  # sentinel padding rows are zero


def test_hot_gather_plain_within_one_bf16_rounding_of_the_jax_default():
    pack = jax_split.PACK
    hot_buf, (_, hot_idx2d, _, _, n_hot, _) = _hot_case(pack)
    bf16 = np.asarray(jax_split.hot_gather_pallas(
        jnp.asarray(hot_buf), jnp.asarray(hot_idx2d), pack=pack, d=jax_split.D,
        interpret=True))
    exact = dispatch.hot_gather(torch.from_numpy(hot_buf), torch.from_numpy(hot_idx2d),
                                pack).numpy()
    assert (np.abs(bf16 - exact) <= 2.0 ** -8 * np.abs(exact)).all()
    assert (bf16 != exact).any()  # the default rounds the hot values to bf16


def test_hot_gather_zero_rows_for_negative_and_sentinel_ids():
    hot = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 16)
    ids = torch.tensor([[0, 31, 32, -1, 7, -32, 1000, 8]], dtype=torch.int32)
    got = dispatch.hot_gather(hot, ids, pack=8)
    rows = hot.reshape(32, 2)
    assert torch.equal(got[[0, 1, 4, 7]], rows[[0, 31, 7, 8]])
    assert not got[[2, 3, 5, 6]].any()


# -- host prep and the Zipf draws -----------------------------------------------------
def test_host_split_at_pack_8_equals_the_jax_function():
    ids = jax_split._zipf_ids(np.random.default_rng(5), 1.1, 4096)
    want = jax_split.host_split(ids, 128)
    got = gather_split_probe.host_split(ids, 128, pack=jax_split.PACK)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uniform", [False, True], ids=["zipf", "uniform"])
def test_host_split_at_pack_1_recombines_the_batch(uniform):
    rng = np.random.default_rng(6)
    ids = (rng.integers(0, 5000, 3000).astype(np.int32) if uniform
           else gather_split_probe._zipf_ids(rng, 1.1, 3000, vocab=5000))
    hot_rows, hot_idx2d, positions, cold_ids, n_hot, n_cold = gather_split_probe.host_split(
        ids, 256, pack=1)
    assert n_hot + n_cold == ids.size and hot_idx2d.shape[1] == gather_split_probe.CH
    both = np.concatenate([hot_rows[hot_idx2d.reshape(-1)[:n_hot]], cold_ids])
    np.testing.assert_array_equal(both[positions], ids)
    assert (hot_idx2d.reshape(-1)[n_hot:] == 256).all()  # the sentinel H·pack


def test_zipf_draws_equal_the_jax_ones():
    np.testing.assert_array_equal(
        gather_split_probe._zipf_ids(np.random.default_rng(7), 1.1, 5000),
        jax_split._zipf_ids(np.random.default_rng(7), 1.1, 5000))
    np.testing.assert_array_equal(
        dedup_probe.zipf_ids(np.random.default_rng(8), 16384, 100_000),
        jax_dedup.zipf_ids(np.random.default_rng(8), 16384, 100_000))


# -- seed_stats ------------------------------------------------------------------
@pytest.mark.parametrize("pattern, generic", [("artifacts/protocol_ctr_fm_s*.json", False),
                                              ("artifacts/protocol_ctr_fm_s*.json", True),
                                              ("artifacts/protocol_mind_s*.json", True)])
def test_seed_stats_equal_the_jax_ones(pattern, generic):
    paths = sorted(glob.glob(pattern))
    assert len(paths) == 3
    fn = "aggregate_generic" if generic else "aggregate"
    assert getattr(seed_stats, fn)(paths) == getattr(jax_seed_stats, fn)(paths)


def test_seed_stats_cli_prints_the_table(capsys):
    seed_stats.main(sorted(glob.glob("artifacts/protocol_ctr_fm_s*.json")))
    out = json.loads(capsys.readouterr().out)
    assert out["teachers"]["fm"]["models"]["deepfm"]["seeds"] == 3


# -- the probes, small, on the CPU -------------------------------------------------
def _one_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_stream_probe_cli_on_cpu(capsys):
    stream_probe.main(["--device", "cpu", "--iters", "1"], tables=2, vocab=300, batch=64,
                      rows=40, width=128)
    rep = _one_json(capsys)
    assert rep["device"] == "cpu" and rep["timer"] == "host clock"
    for key in ("adam_stream_torch", "adam_stream_cuda", "random_gather_26tables",
                "gather_bytes_vs_rows", "perrow_walk"):
        assert key in rep
    assert set(rep["gather_bytes_vs_rows"]) >= {"f32_w128", "bf16_w128", "f32_w64", "f32_w16",
                                                "bf16_w16"}
    assert rep["perrow_walk"]["cycles_per_row_at_clock"] is None  # no card, no clock


@pytest.mark.parametrize("flags", [[], ["--uniform"]], ids=["zipf", "uniform"])
def test_gather_split_probe_cli_on_cpu_is_exact(capsys, flags):
    gather_split_probe.main(["--device", "cpu", "--iters", "1", "--hot", "64", *flags],
                            tables=3, vocab=2000, batch=700)
    rep = _one_json(capsys)
    assert rep["max_abs_err"] == 0.0
    assert rep["distribution"] == ("uniform" if flags else "zipf(1.1)")
    assert 0.0 < rep["hot_coverage"] < 1.0 and rep["full_ms"] > 0 and rep["split_ms"] > 0


def test_dedup_probe_cli_on_cpu(capsys):
    dedup_probe.main(["--device", "cpu", "--iters", "1"], fields=2, vocab=1000, batch=512)
    rep = _one_json(capsys)
    for dist in ("uniform", "zipf"):
        assert rep[dist]["max_abs_err"] == 0.0
        assert set(rep[dist]) >= {"plain", "uniq_only", "expand_only", "dedup_chain"}
        assert rep[dist]["unique_rows_per_field"]["max"] <= 512
    assert rep["zipf"]["ucap"] < rep["uniform"]["ucap"]  # skew repeats ids


# -- probe_check's limits ------------------------------------------------------------
def _checks():
    for name, tables in probe_check.ADAM_CASES.items():
        if sum(n for n, _, _ in tables) <= 2_000_000:  # the 26 bench tables only on the card
            yield f"adam {name}", lambda r, t=tables: probe_check.check_adam(
                dispatch.adam_stream_pass_, r, t, "cpu")
    for name, (n, w, offset) in probe_check.PERROW_CASES.items():
        if n <= 1000:  # the plain walk is a Python loop
            yield f"perrow {name}", lambda r, n=n, w=w, o=offset: probe_check.check_perrow(
                dispatch.perrow_colsum, r, n, w, o, "cpu")
    for name, args in probe_check.HOT_CASES.items():
        yield f"hot {name}", lambda r, a=args: probe_check.check_hot(
            dispatch.hot_gather, r, *a, "cpu")


@pytest.mark.parametrize("name, check", list(_checks()), ids=[c[0] for c in _checks()])
def test_probe_check_limits_reject_the_wrong_results(name, check):
    res = check(np.random.default_rng(9))
    assert probe_check.passed(res), res
    assert res["wrong_rejected"] and res["max_abs_err"] == 0.0
