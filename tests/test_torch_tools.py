"""The port's single-card measuring tools against the JAX package on the
CPU: the roofline's phases and accounting (``tools/roofline.py``), the
dense-phase probe's matmul shapes and ``DenseTail`` (``tools/dense_probe.py``)
and the kernel-against-route sweep (``tools/kernel_sweep.py``), at small
sizes.  On the CPU every kernel wrapper takes its plain version and the
times are host-clock times: these tests hold what the tools compute and
that each runs, not how fast."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recsys_tpu.tools import dense_probe as jdense
from recsys_tpu.tools import roofline as jroof
from recsys_tpu_torch.convert import dense_tail_params_from_jax
from recsys_tpu_torch.tools import dense_probe, kernel_sweep, roofline

CPU = torch.device("cpu")
VOCAB = 1000  # the cut vocabulary the phases run at


def test_build_phases_has_the_jax_phase_set(monkeypatch):
    monkeypatch.setattr(jroof, "VOCAB", 4096)  # the phase set does not depend on it
    jphases, janalytic = jroof.build_phases(64, np.random.default_rng(0))
    phases, analytic = roofline.build_phases(64, device=CPU, vocab=VOCAB)
    assert set(phases) == set(jphases) == set(analytic) == set(janalytic)
    # 3 x the forward matmul FLOPs, whatever the tables' layout
    assert analytic["dense"] == {"bytes": 0, "flops": janalytic["dense"]["flops"]}


@pytest.mark.parametrize("batch", [64, 16384])
def test_roofline_bytes(batch):
    a = roofline.analytic(batch, VOCAB)
    table_bytes = 26 * VOCAB * 16 * 4
    lookups = batch * 26
    assert a["update"]["bytes"] == 7 * table_bytes
    # 64-byte logical rows read, the output written, the int64 ids read
    assert a["gather"]["bytes"] == lookups * (2 * 64 + 8)
    assert a["scatter"]["bytes"] == lookups * (64 + 8) + table_bytes
    assert a["fused_bwd"]["bytes"] == 6 * table_bytes + lookups * (64 + 8)
    assert all(a[p]["flops"] == 0 for p in ("gather", "scatter", "update", "fused_bwd"))


def test_roofline_main_runs_every_phase_and_the_step(capsys):
    rep = roofline.main(["--device", "cpu", "--batch", "64", "--iters", "1"], vocab=VOCAB)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rep))
    assert rep["timer"] == "host clock" and rep["step_phases"] == ["gather", "dense", "fused_bwd"]
    for name, e in rep["phases"].items():
        assert np.isfinite(e["ms"]) and e["ms"] > 0, name
        assert "sol_ms" not in e  # no bound without a card's peaks
    assert np.isfinite(rep["full_step_ms"]) and rep["full_step_ms"] > 0
    assert rep["phase_sum_ms"] == sum(rep["phases"][p]["ms"] for p in rep["step_phases"])
    assert rep["residual_ms"] == rep["full_step_ms"] - rep["phase_sum_ms"]


def test_full_step_on_the_optax_path_and_fused_mlps():
    rng = np.random.default_rng(0)
    for fused, fused_mlps in ((False, False), (True, True)):
        ms = roofline.full_step_ms(64, rng, 1, fused=fused, fused_mlps=fused_mlps, device=CPU,
                                   vocab=VOCAB, warmup=1)
        assert np.isfinite(ms) and ms > 0


def test_fused_bwd_phase_updates_the_tables_as_adam():
    """The fused phase is the step's table update: every table row a batch
    id touched moves, the others stay bit for bit."""
    phases, _ = roofline.build_phases(64, np.random.default_rng(3), device=CPU, vocab=VOCAB)
    tabs = phases["fused_bwd"]()
    before = {k: t.clone() for k, t in tabs.items()}
    phases["fused_bwd"]()
    ids = np.random.default_rng(3).integers(0, VOCAB, (64, 26), dtype=np.int64)
    for g in range(26):
        moved = (tabs[f"table_{g}"] != before[f"table_{g}"]).any(1).numpy()
        assert set(np.flatnonzero(moved)) <= set(ids[:, g]) and moved.any()


def test_phase_matmuls_equal_jax():
    assert dense_probe.phase_matmuls() == jdense.phase_matmuls()
    assert len(dense_probe.phase_matmuls()) == 24  # 8 layers x (fwd, dgrad, wgrad)


def _jax_tail(kernel_interaction, batch=64):
    rng = np.random.default_rng(5)
    dense = rng.random((batch, 13), np.float32)
    embs = rng.standard_normal((batch, 26, 16)).astype(np.float32)
    labels = rng.integers(0, 2, batch).astype(np.float32)
    tail = jdense.build_tail(jnp.float32, kernel_interaction)
    params = tail.init(jax.random.PRNGKey(1), jnp.asarray(dense), jnp.asarray(embs))["params"]

    def loss(p):
        logits = tail.apply({"params": p}, dense, embs)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, labels)), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return dense, embs, labels, params, np.asarray(logits), grads


@pytest.mark.parametrize("kernel_interaction", [True, False], ids=["kernel", "gram"])
def test_dense_tail_matches_flax(kernel_interaction):
    """f32 logits within 1e-5, each parameter's gradient within 1e-4 of
    the flax tail's in relative norm, on both interaction routes."""
    dense, embs, labels, params, want_logits, grads = _jax_tail(kernel_interaction)
    tail = dense_probe.DenseTail(torch.float32, kernel_interaction)
    tail.load_state_dict(dense_tail_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tail))
    got = tail(torch.from_numpy(dense), torch.from_numpy(embs))
    np.testing.assert_allclose(got.detach().numpy(), want_logits, rtol=1e-5, atol=1e-5)

    step = dense_probe.tail_step(tail, torch.from_numpy(dense), torch.from_numpy(embs),
                                 torch.from_numpy(labels))
    got_grads = dict(zip([n for n, _ in tail.named_parameters()], step()))
    want = dense_tail_params_from_jax(jax.tree_util.tree_map(np.asarray, grads), tail)
    assert set(want) == set(got_grads)
    for name, g in want.items():
        err = float(torch.linalg.norm(got_grads[name] - g) / torch.linalg.norm(g))
        assert err <= 1e-4, (name, err)


def test_tail_step_split_is_the_same_gradient():
    """The batch in 4 slices (DLRM's ``dense_microbatch``) is the same
    gradient as one slice, in f32 up to the sums' order."""
    dense, embs, labels, *_ = _jax_tail(True)
    torch.manual_seed(0)
    tail = dense_probe.DenseTail(torch.float32)
    args = (torch.from_numpy(dense), torch.from_numpy(embs), torch.from_numpy(labels))
    whole = dense_probe.tail_step(tail, *args)()
    tail.dense_microbatch = 4
    for a, b in zip(whole, dense_probe.tail_step(tail, *args)()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_dense_probe_main_reports_the_floor_and_levers(capsys):
    rep = dense_probe.main(["--device", "cpu", "--iters", "1"], batch=64, peak_n=64)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rep))
    assert [r["label"] for r in rep["matmuls"]] == [m[0] for m in dense_probe.phase_matmuls()]
    assert rep["composition_floor_ms"] == pytest.approx(
        sum(r["ms"] for r in rep["matmuls"]) + rep["interaction_fwd_bwd_ms"])
    assert set(rep["phase_ms"]) == {label for label, _ in dense_probe.LEVERS}
    assert all(np.isfinite(v) and v > 0 for v in rep["phase_ms"].values())


def test_kernel_sweep_quick_grid_times_both_routes(capsys):
    rep = kernel_sweep.main(["all", "--quick", "--device", "cpu", "--iters", "1"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rep))
    (row,) = rep["interactions"]
    assert (row["b"], row["f"], row["d"]) == (256, 8, 16) and row["dot_in_domain"]
    for k in ("fm_torch_ms", "fm_kernel_ms", "dot_torch_ms", "dot_kernel_ms"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    (row,) = rep["topk"]
    assert row["in_domain"]
    for k in ("torch_full_ms", "torch_stream_ms", "library_ms", "kernel_ms"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    assert row["speedup_vs_best_torch"] == min(row["torch_full_ms"],
                                               row["torch_stream_ms"]) / row["kernel_ms"]


def test_kernel_sweep_leaves_the_dot_kernel_out_of_its_domain():
    rows = kernel_sweep.sweep_interactions(1, device=CPU, batches=(4,), fields=(300,),
                                           dims=(64,))
    assert rows[0]["dot_in_domain"] is False and rows[0]["dot_kernel_ms"] is None


def test_topk_routes_agree_with_the_plain_kernel():
    """The two torch routes the sweep times give the kernel's answer."""
    from recsys_tpu_torch.kernels import topk as topk_ref
    from recsys_tpu_torch.train import retrieval

    g = torch.Generator().manual_seed(0)
    q, items = torch.randn((16, 8), generator=g), torch.randn((3000, 8), generator=g)
    want_v, want_i = topk_ref.topk_scores(q, items, 10)
    for fn in (retrieval.score_matrix_topk,
               lambda a, b, k: retrieval.tile_scan_topk(a, b, k, tile=512)):
        v, i = fn(q, items, 10)
        torch.testing.assert_close(v, want_v, rtol=1e-6, atol=1e-6)
        assert torch.equal(i, want_i)
