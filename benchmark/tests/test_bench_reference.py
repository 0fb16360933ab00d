"""The plain reference against the port's DLRM at a tiny size on the CPU:
the port in float32 throughout (compute in float32, the table cotangent
summed in float32) takes the same steps as the reference, from the same
start, on the same batches."""
import numpy as np
import pytest
import torch

from benchkit import compare, registry
from benchkit.seeds import TRAFFIC, sub_seed

ROWS = [40, 7, 300, 5, 60, 3, 200, 11, 9, 120, 30, 250, 8, 4, 70, 150, 10, 20, 13, 4, 100,
        18, 15, 90, 25, 33]


def tiny(config="dlrm-criteo-kaggle", compute="float32", bf16_cot=False, batch=128):
    c = registry.cell("kaggle-train-zipf")
    cfg = registry.load_json("configs", config)
    cfg = dict(cfg, table_rows=ROWS, port=dict(cfg["port"], compute_dtype=compute,
                                                embedding_fused_bf16=bf16_cot))
    c.config, c.traffic = cfg, dict(c.traffic, pool_batches=3)
    c.spec = dict(c.spec, batch=batch)
    return c


def batches(c, seed):
    dims = registry.family("dlrm").dims(c.config)
    return registry.generator(c.traffic["generator"]).make_pool(
        c.traffic, dims["rows"], dims["num_dense"], c.batch, sub_seed(seed, TRAFFIC))


@pytest.mark.parametrize("config", ["dlrm-criteo-kaggle", "dlrm-criteo-tb10m"])
def test_forward_matches_the_port(config):
    fam = registry.family("dlrm")
    c = tiny(config)
    b = batches(c, 11)[0]
    prog = fam.Program(c.config, 11, "cpu")
    prog.model.eval()
    with torch.no_grad():
        got = prog.model({k: torch.from_numpy(v) for k, v in b.items()})
    ref = fam._reference()
    dense = fam.make_dense(c.config, 11, "cpu")
    tables = [fam.fill_table(torch.empty(v, c.config["arch_sparse_feature_size"]), 11, t)
              for t, v in enumerate(ROWS)]
    want = ref.forward(dense, tables, torch.from_numpy(b["sparse"]).long(),
                       torch.from_numpy(b["dense"]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_three_steps_match_the_port_in_float32(seed):
    """Losses, first gradients and changes agree to float32 rounding: the
    reference's Adam, its compact tables and its gradient are the port's."""
    fam = registry.family("dlrm")
    c = tiny()
    bs = batches(c, seed)
    got = fam.Program(c.config, seed, "cpu").check_steps(bs)
    want = fam.reference_readings(c.config, seed, bs, "cpu")
    assert set(got["grad_norm"]) == set(want["grad_norm"])
    gaps = compare.gaps(got, want)
    assert gaps["loss_gap"][0] < 1e-5
    assert gaps["grad_gap"][0] < 1e-4
    assert gaps["change_gap"][0] < 2e-3  # Adam's first steps flip near-zero gradients


def test_untouched_rows_stay_and_compact_tables_are_whole():
    """The program moves no row that no step touched: its change over the
    whole table equals the change over the touched rows."""
    fam = registry.family("dlrm")
    c = tiny()
    bs = batches(c, 4)
    prog = fam.Program(c.config, 4, "cpu")
    prog.check_steps(bs)
    for t, v in enumerate(ROWS):
        p = prog.trainer.tables()[f"table_{t}"]
        start = fam.fill_table(torch.empty(p.shape), 4, t)
        touched = np.unique(np.concatenate([b["sparse"][:, t] for b in bs]))
        still = np.setdiff1d(np.arange(v), touched)
        torch.testing.assert_close(p[still], start[still], rtol=0, atol=0)
