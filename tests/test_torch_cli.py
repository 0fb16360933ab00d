"""The port's ``python -m recsys_tpu_torch.cli`` on the CPU: each ported
task at a few epochs prints the JAX CLI's result line with its metric in
range (as tests/test_cli.py reads the JAX one); the tasks and flags the
port does not have yet exit naming their ROADMAP item; and the CLI, the
protocol runner and the new models import neither JAX nor the JAX
package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from recsys_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]


def _run(capsys, *argv) -> str:
    res = cli.main([*argv, "--device", "cpu"])
    assert res["loss"] and np.isfinite(res["loss"]).all(), res
    return capsys.readouterr().out


def _value(out: str, pattern: str) -> float:
    m = re.search(pattern, out)
    assert m, out
    return float(m.group(1))


@pytest.mark.parametrize("argv", [
    ("ctr", "--model", "fm", "--epochs", "1", "--lr", "1e-2"),
    ("ctr", "--model", "dlrm", "--epochs", "1", "--bf16",
     "--embedding-optimizer", "fused_adam"),
    ("ctr", "--model", "deepfm", "--epochs", "1", "--embedding-optimizer",
     "fused_rowwise_adagrad"),
], ids=["fm", "dlrm-bf16-fused_adam", "deepfm-fused_rowwise_adagrad"])
def test_ctr_prints_test_auc(capsys, argv):
    auc = _value(_run(capsys, *argv), r"test AUC: ([0-9.]+)\n")
    assert 0.4 < auc <= 1.0


@pytest.mark.parametrize("model, loss", [("dssm", "softmax"), ("senet", "softmax"),
                                         ("fm", "softmax"), ("dssm", "bce")])
def test_match_prints_recall(capsys, model, loss):
    out = _run(capsys, "match", "--model", model, "--epochs", "2", "--retrieval-loss", loss)
    m = re.search(r"recall@10: ([0-9.]+) over (\d+) items \(random ([0-9.]+)\)", out)
    assert m, out
    assert 0.0 <= float(m.group(1)) <= 1.0 and int(m.group(2)) == 150
    assert float(m.group(3)) == round(10 / 150, 4)


def test_sasrec_prints_hr_and_ndcg(capsys):
    out = _run(capsys, "sasrec", "--epochs", "1")
    m = re.search(r"test HR@10=([0-9.]+) NDCG@10=([0-9.]+)\n", out)
    assert m, out
    hr, ndcg = float(m.group(1)), float(m.group(2))
    assert 0.0 <= ndcg <= hr <= 1.0


@pytest.mark.parametrize("task", ["youtube", "mind"])
def test_sequence_retrieval_prints_recall(capsys, task):
    out = _run(capsys, task, "--epochs", "2")
    m = re.search(r"recall@10: ([0-9.]+) over (\d+) items \(random ([0-9.]+)\)", out)
    assert m, out
    assert 0.0 <= float(m.group(1)) <= 1.0 and int(m.group(2)) == 151
    assert re.search(r"epoch 2/2 loss=[0-9.]+", out)


@pytest.mark.parametrize("argv, item", [
    (("ncf",), "Queue 1 item 6"),
    (("din",), "Queue 1 item 7"),
    (("multitask", "--model", "esmm"), "Queue 1 item 8"),
    (("ctr", "--data", "criteo.csv"), "Queue 1 item 9"),
    (("ctr", "--data", "criteo.csv", "--stream"), "Queue 1 item 9"),
    (("match", "--ml100k", "ml-100k"), "Queue 1 item 9"),
    (("sasrec", "--ratings", "ratings.csv"), "Queue 1 item 9"),
    (("ctr", "--reviews", "r.json", "--meta", "m.json"), "Queue 1 item 7"),
    (("ctr", "--census", "train.csv", "test.csv"), "Queue 1 item 8"),
    (("ctr", "--embedding-optimizer", "lazy_adam"), "Queue 1 item 9"),
    (("ctr", "--embedding-optimizer", "rowwise_adagrad"), "Queue 1 item 9"),
    (("ctr", "--embedding-engine", "a2a"), "Queue 1 item 10"),
    (("ctr", "--mesh-model", "2"), "Queue 1 item 10"),
    (("ctr", "--sample-num", "1000"), "Queue 1 item 9"),
    (("ctr", "--capacity-factor", "1.5"), "Queue 1 item 10"),
])
def test_refused_tasks_and_flags_name_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit, match=re.escape(f"ROADMAP.md {item}")):
        cli.main([*argv, "--device", "cpu"])


def test_bf16_is_refused_outside_dlrm():
    with pytest.raises(SystemExit, match="--model dlrm"):
        cli.main(["ctr", "--model", "fm", "--bf16", "--device", "cpu"])


def test_entry_points_import_neither_jax_nor_the_jax_package():
    code = ("import sys, recsys_tpu_torch.cli, recsys_tpu_torch.tools.protocol, "
            "recsys_tpu_torch.models.match.mind, recsys_tpu_torch.models.match.two_tower, "
            "recsys_tpu_torch.models.match.fm_match, recsys_tpu_torch.train.export, "
            "recsys_tpu_torch.data.movielens, recsys_tpu_torch.data.realistic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'recsys_tpu', 'pandas')]; print(bad); "
            "sys.exit(bool(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
