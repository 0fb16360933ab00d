"""The port's protocol modes ``ncf``, ``din``, ``multitask`` and ``census``
on the CPU at a tiny size and one epoch (ncf two, for its every-second-epoch
reading): each report has the JAX report's keys (from the JAX package's own
records in ``artifacts/``) plus ``fit_examples_per_s`` (a model's, where
the report has models), with metrics in range; ``--out`` writes the
report; the census mode refuses models other than MMoE and PLE, as the JAX
runner does."""
import json
import math
from pathlib import Path

import pytest

from recsys_tpu_torch.tools import protocol

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
RECORDS = {"ncf": "protocol_ncf_s0.json", "din": "protocol_din.json",
           "multitask": "protocol_multitask.json", "census": "protocol_census_s0.json"}
ARGV = {"ncf": ["--users", "300", "--items", "200", "--epochs", "2"],
        "din": ["--users", "300", "--items", "200", "--maxlen", "10"],
        "multitask": ["--rows", "4000", "--batch-size", "256"],
        "census": ["--rows", "3000", "--batch-size", "256"]}


def _jax_report(mode: str) -> dict:
    return json.loads((ARTIFACTS / RECORDS[mode]).read_text().strip().splitlines()[-1])


@pytest.mark.parametrize("mode", list(ARGV))
def test_mode_report_has_the_jax_reports_keys(tmp_path, capsys, mode):
    out = tmp_path / f"protocol_{mode}.json"
    protocol.main([mode, *ARGV[mode], "--epochs" if mode != "ncf" else "--seed",
                   "1", "--device", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    jax_rep = _jax_report(mode)
    assert rep["mode"] == mode
    if "models" in jax_rep:
        assert rep.keys() == jax_rep.keys()
        assert list(rep["models"]) == list(jax_rep["models"])
        for m, row in rep["models"].items():
            assert row.keys() == jax_rep["models"][m].keys() | {"fit_examples_per_s"}
            assert row["fit_examples_per_s"] > 0 and row["epochs_ran"] == 1
            assert all(0.0 <= v <= 1.0 for k, v in row.items() if k.startswith("auc_"))
        oracles = [v for k, v in rep.items() if k.startswith("oracle_auc")]
        assert len(oracles) == 2 and all(0.5 < v <= 1.0 for v in oracles)
        return
    assert set(rep) == set(jax_rep) | {"fit_examples_per_s"}
    assert all(math.isfinite(v) for v in rep.values() if isinstance(v, (int, float)))
    assert rep["fit_examples_per_s"] > 0
    if mode == "ncf":
        assert 0.0 <= rep["NDCG@10"] <= rep["HR@10"] <= rep["best_HR@10"] <= 1.0
        assert rep["random_HR@10"] == jax_rep["random_HR@10"] and rep["users"] <= 300
    else:
        assert 0.0 <= rep["test_auc"] <= 1.0 and rep["maxlen"] == 10
        assert rep["epochs_ran"] == 1 and rep["train_rows"] > 0


def test_census_mode_refuses_other_models():
    with pytest.raises(ValueError, match="mmoe/ple"):
        protocol.main(["census", "--rows", "100", "--models", "esmm", "--device", "cpu"])


def test_multitask_model_refuses_unknown_names():
    with pytest.raises(ValueError, match="choose from esmm, mmoe, ple"):
        protocol.multitask_model("mmoe2", None, ("a", "b"), ("a", "b"))
