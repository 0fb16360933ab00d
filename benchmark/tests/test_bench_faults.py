"""The check fails what it must fail, at a size a CPU test run holds.

A whole run of a small cell on the CPU (the harness's look for a card
skipped), with the timed path broken underneath, comes out not correct:
once for each fault a one-chip training cell can have.  And the control,
the reference computed in float8 put in the program's place, fails the
cell's limits."""
import time

import pytest
import torch

from benchkit import cell as cell_lib
from benchkit import compare, registry
from benchkit.seeds import TRAFFIC, sub_seed

ROWS = [40, 7, 300, 5, 60, 3, 200, 11, 9, 120, 30, 250, 8, 4, 70, 150, 10, 20, 13, 4, 100,
        18, 15, 90, 25, 33]
CELL = "kaggle-train-zipf"  # whose limits the small cell is held to
BATCH = 1024


def small_cell():
    c = registry.cell(CELL)
    c.config = dict(c.config, table_rows=ROWS)
    c.traffic = dict(c.traffic, pool_batches=6)
    c.spec = dict(c.spec, batch=BATCH)
    return c


def run(seed=2**31 + 9):
    return cell_lib.run_cell(small_cell(), seed, 0.2, False, "cpu", time.time())


def test_a_sound_run_is_correct():
    assert run()["correct"] is True


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from recsys_tpu_torch.train import streaming_embed
    monkeypatch.setattr(streaming_embed, "apply_updates_fused", lambda *a, **k: None)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run()
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails(monkeypatch):
    from recsys_tpu_torch.train import losses
    whole = losses.bce_with_logits

    def half(logits, labels):  # the mean over the first half only
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(losses, "bce_with_logits", half)
    res = run()
    assert res["correct"] is False


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_float8_control_fails_the_limits(seed):
    c = small_cell()
    fam = registry.family("dlrm")
    dims = fam.dims(c.config)
    bs = registry.generator(c.traffic["generator"]).make_pool(
        c.traffic, dims["rows"], dims["num_dense"], BATCH, sub_seed(seed, TRAFFIC))[:3]
    ref = fam.reference_readings(c.config, seed, bs, "cpu")
    control = fam.reference_readings(c.config, seed, bs, "cpu", quant="fp8")
    correct, checks = compare.judge(compare.gaps(control, ref), c.spec["limits"])
    assert correct is False, checks


def test_judge_fails_what_is_not_a_number_and_compares_only_limited_numbers():
    found = {"loss_gap": (0.5, "step 1"), "grad_gap": (0.01, "table.3"),
             "change_gap": (float("nan"), "table.4")}
    ok, checks = compare.judge(found, {"grad_gap": 0.06})
    assert ok and list(checks) == ["grad_gap"]
    ok, _ = compare.judge(found, {"grad_gap": 0.06, "change_gap": 0.04})
    assert not ok
    with pytest.raises(ValueError):
        compare.judge(found, {"nope": 1.0})


@pytest.mark.parametrize("leaf", ["a", "b", "c"])  # below, at and above the median
@pytest.mark.parametrize("moved", [0.0, 2.0])  # not at all, or double
def test_a_leaf_that_moved_double_or_not_at_all_reads_one(leaf, moved):
    ref = {"loss": [0.7], "grad_norm": {"a": 0.01, "b": 2.0, "c": 3.0},
           "change_norm": {"a": 0.003, "b": 2.0, "c": 3.0}}
    wrong = dict(ref, change_norm=dict(ref["change_norm"],
                                       **{leaf: moved * ref["change_norm"][leaf]}))
    assert compare.gaps(wrong, ref)["change_gap"] == (pytest.approx(1.0), leaf)
    ok, _ = compare.judge(compare.gaps(wrong, ref), {"change_gap": 0.04})
    assert not ok


def test_a_gradient_that_is_all_but_zero_is_measured_against_a_floor():
    """A leaf whose reference gradient is under a thousandth of the median
    leaf's is held against that thousandth, and left out of the change."""
    ref = {"loss": [0.7], "grad_norm": {"a": 1e-9, "b": 2.0, "c": 3.0},
           "change_norm": {"a": 1e-6, "b": 2.0, "c": 3.0}}
    prog = dict(ref, grad_norm=dict(ref["grad_norm"], a=2e-5), change_norm=dict(
        ref["change_norm"], a=3e-3))
    found = compare.gaps(prog, ref)
    assert found["grad_gap"] == (pytest.approx((2e-5 - 1e-9) / 2e-3), "a")
    assert found["change_gap"] == (0.0, "")
