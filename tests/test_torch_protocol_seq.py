"""The port's sequence protocol modes (``sasrec``, ``seqret``, ``mind``,
``dssm``) on the CPU at 300 users, 150 items and one epoch: each report has
the JAX report's keys (from the JAX package's own records in
``artifacts/``) plus ``fit_examples_per_s``, with finite values in range;
``--out`` writes the report; an unknown mode is refused."""
import json
import math
from pathlib import Path

import pytest

from recsys_tpu_torch.tools import protocol

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
RECORDS = {"sasrec": "protocol_sasrec_drift2_s0.json", "seqret": "protocol_seqret.json",
           "mind": "protocol_mind_s0.json", "dssm": "protocol_dssm_s0.json"}


def _jax_report(mode: str) -> dict:
    """The JAX run's report: the last line of its record (the seqret record
    keeps the epoch lines before it)."""
    return json.loads((ARTIFACTS / RECORDS[mode]).read_text().strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["sasrec", "seqret", "mind", "dssm"])
def test_mode_report_has_the_jax_reports_keys(tmp_path, capsys, mode):
    out = tmp_path / f"protocol_{mode}.json"
    protocol.main([mode, "--users", "300", "--items", "150", "--epochs", "1",
                   "--device", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    assert rep["mode"] == mode and rep["users"] == 300
    if mode == "dssm":
        jax_rep = _jax_report(mode)
        assert rep.keys() == jax_rep.keys()
        assert list(rep["models"]) == list(jax_rep["models"])
        for m in rep["models"].values():
            assert m.keys() == {"recall@10", "seconds", "fit_examples_per_s"}
            assert 0.0 <= m["recall@10"] <= 1.0 and m["fit_examples_per_s"] > 0
        return
    assert set(rep) == set(_jax_report(mode)) | {"fit_examples_per_s"}
    assert all(math.isfinite(v) for v in rep.values() if isinstance(v, (int, float)))
    assert rep["fit_examples_per_s"] > 0
    if mode == "sasrec":
        assert 0.0 <= rep["NDCG@10"] <= rep["HR@10"] <= 1.0 and rep["drift_scale"] == 6.0
    else:
        assert 0.0 <= rep["recall@10"] <= 1.0 and rep["random_recall@10"] > 0


def test_modes_take_the_jax_runners_batch_and_epochs():
    assert protocol.MODE_DEFAULTS == {"ctr": (512, 10), "ncf": (1024, 8), "sasrec": (256, 5),
                                      "seqret": (1024, 5), "din": (1024, 3),
                                      "multitask": (512, 5), "mind": (1024, 5),
                                      "dssm": (2048, 4), "census": (512, 5)}
    assert protocol.MODE_ROWS == {"ctr": 1_000_000, "multitask": 1_000_000,
                                  "census": 200_000}
    assert protocol.DIN_MAXLEN == 40


@pytest.mark.parametrize("mode, item", [("nope", "choose from")])
def test_unported_modes_are_refused(capsys, mode, item):
    with pytest.raises(SystemExit):
        protocol.main([mode, "--device", "cpu"])
    assert item in capsys.readouterr().err
