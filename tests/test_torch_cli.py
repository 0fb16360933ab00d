"""The port's ``python -m recsys_tpu_torch.cli`` on the CPU: each ported
task at a few epochs prints the JAX CLI's result line with its metric in
range (as tests/test_cli.py reads the JAX one), din and multitask also on
review and census files the test writes; ``ctr``'s mesh flags run in one
process and under torchrun; the file flags run on the
``tests/assets`` files; and the CLI, the protocol runner and
the models import neither JAX, pandas nor the JAX package."""
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from recsys_tpu_torch import cli
from recsys_tpu_torch.data import census
from recsys_tpu_torch.data.realistic import realistic_census

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


def test_ncf_prints_hr_and_ndcg_every_second_epoch(capsys):
    res = cli.main(["ncf", "--epochs", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    lines = re.findall(r"epoch (\d)/4 loss=[0-9.]+( HR@10=([0-9.]+) NDCG@10=([0-9.]+))?\n", out)
    assert [(e, bool(m)) for e, m, _, _ in lines] == [("1", False), ("2", True), ("3", False),
                                                      ("4", True)]
    assert len(res["loss"]) == 4 and np.isfinite(res["loss"]).all()
    np.testing.assert_allclose(res["HR@10"], [float(lines[1][2]), float(lines[3][2])],
                               atol=5e-5)  # the lines round to 4 places
    assert all(0.0 <= n <= h <= 1.0 for h, n in zip(res["HR@10"], res["NDCG@10"]))


def _write_reviews(tmp_path) -> list:
    """A JSON-lines reviews dump and a Python-literal meta dump."""
    rng = np.random.default_rng(3)
    with open(tmp_path / "reviews.json", "w") as f:
        for u in range(80):
            for t in range(int(rng.integers(3, 12))):
                f.write(json.dumps({"reviewerID": f"U{u}", "asin": f"B{rng.integers(0, 60):02d}",
                                    "unixReviewTime": t}) + "\n")
    with open(tmp_path / "meta.json", "w") as f:
        for i in range(60):
            f.write(repr({"asin": f"B{i:02d}", "categories": [["E", f"c{i % 6}"]]}) + "\n")
    return ["--reviews", str(tmp_path / "reviews.json"), "--meta", str(tmp_path / "meta.json")]


def _write_census(tmp_path) -> list:
    train, test, _ = realistic_census(num_train=3000, num_test=1000, seed=1)
    census.write_columns(str(tmp_path / "census.data"), train)
    census.write_columns(str(tmp_path / "census.test"), test)
    return ["--census", str(tmp_path / "census.data"), str(tmp_path / "census.test")]


@pytest.mark.parametrize("files", [False, True], ids=["synthetic", "files"])
def test_din_prints_test_auc(capsys, tmp_path, files):
    argv = ["din", "--epochs", "2", *(_write_reviews(tmp_path) if files else [])]
    auc = _value(_run(capsys, *argv), r"test AUC: ([0-9.]+)\n")
    assert 0.0 <= auc <= 1.0


@pytest.mark.parametrize("model, files", [("esmm", False), ("mmoe", False), ("ple", False),
                                          ("esmm", True), ("mmoe", True), ("ple", True)],
                         ids=["esmm", "mmoe", "ple", "esmm-census", "mmoe-census",
                              "ple-census"])
def test_multitask_prints_each_heads_auc(capsys, tmp_path, model, files):
    argv = ["multitask", "--model", model, "--epochs", "1",
            *(_write_census(tmp_path) if files else [])]
    out = _run(capsys, *argv)
    tasks = ("income", "marital") if files else ("ctr", "cvr")
    heads = ("ctr", "ctcvr") if model == "esmm" else tasks
    found = re.findall(r"(\w+) AUC: ([0-9.]+)\n", out)
    assert [h for h, _ in found] == list(heads)
    assert all(0.0 <= float(v) <= 1.0 for _, v in found)


def test_multitask_refuses_models_it_does_not_have():
    with pytest.raises(SystemExit, match="esmm, mmoe or ple"):
        cli.main(["multitask", "--device", "cpu"])


@pytest.mark.parametrize("argv, dropped", [
    (("ctr", "--embedding-engine", "a2a"), [0]),
    (("ctr", "--embedding-engine", "a2a_pipelined", "--capacity-factor", "0"), [0]),
    (("ctr", "--model", "dlrm", "--mesh-model", "1", "--embedding-engine", "psum",
      "--embedding-optimizer", "fused_adam"), None),
], ids=["a2a", "capacity-factor-0", "dlrm-psum-fused_adam"])
def test_mesh_flags_run_in_one_process(capsys, argv, dropped):
    """World size 1: the (1, 1) mesh the JAX CLI builds on one chip, every
    table through the engine (its one shard); ``--capacity-factor 0`` is
    the exact mode, which drops nothing."""
    res = cli.main([*argv, "--epochs", "1", "--device", "cpu"])
    assert 0.0 <= _value(capsys.readouterr().out, r"test AUC: ([0-9.]+)\n") <= 1.0
    assert np.isfinite(res["loss"]).all() and res.get("a2a_dropped") == dropped


def test_mesh_model_runs_under_torchrun():
    """``torchrun --nproc-per-node 2 ... ctr --mesh-model 2``: a (1, 2) mesh
    of two gloo ranks, the tables row-sharded over them; both ranks train
    the same replica and print the same test AUC."""
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "recsys_tpu_torch.cli", "ctr",
                        "--mesh-model", "2", "--epochs", "1", "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    aucs = re.findall(r"test AUC: ([0-9.]+)\n", r.stdout)
    assert len(aucs) == 2 and aucs[0] == aucs[1], r.stdout
    assert 0.0 <= float(aucs[0]) <= 1.0


ASSETS = REPO / "tests" / "assets"


@pytest.mark.parametrize("argv, pattern", [
    (("ctr", "--model", "deepfm", "--data", str(ASSETS / "criteo_sample.csv")),
     r"test AUC: ([0-9.]+)\n"),
    (("ctr", "--model", "fm", "--data", str(ASSETS / "criteo_sample.csv"), "--sample-num",
      "250"), r"test AUC: ([0-9.]+)\n"),
    (("ctr", "--model", "dlrm", "--embedding-optimizer", "lazy_adam"),
     r"test AUC: ([0-9.]+)\n"),
    (("ctr", "--model", "dlrm", "--bf16", "--embedding-optimizer", "rowwise_adagrad"),
     r"test AUC: ([0-9.]+)\n"),
    (("match", "--model", "dssm", "--ml100k", str(ASSETS / "ml100k")),
     r"recall@10: ([0-9.]+) over \d+ items"),
    (("ncf", "--ratings", str(ASSETS / "ml100k" / "u.data")),
     r"epoch 2/2 loss=[0-9.]+ HR@10=([0-9.]+) NDCG@10=[0-9.]+\n"),
    (("sasrec", "--ratings", str(ASSETS / "ml_latest_ratings.csv"), "--maxlen", "20"),
     r"test HR@10=([0-9.]+) NDCG@10=[0-9.]+\n"),
    (("youtube", "--ratings", str(ASSETS / "ml100k" / "u.data"), "--maxlen", "20"),
     r"recall@10: ([0-9.]+) over \d+ items"),
], ids=["ctr-data", "ctr-sample-num", "ctr-lazy_adam", "ctr-rowwise_adagrad", "match-ml100k",
        "ncf-ratings", "sasrec-ratings", "youtube-ratings"])
def test_file_flags_and_sparse_optimizers_run(capsys, argv, pattern):
    metric = _value(_run(capsys, *argv, "--epochs", "2"), pattern)
    assert 0.0 <= metric <= 1.0


def test_ctr_streams_a_glob_of_criteo_files(capsys, tmp_path, monkeypatch):
    """``--data GLOB --stream``: the files stream through the C++ parser
    (hashed into 2^10 buckets here to stay small), no validation, and the
    final training loss is printed."""
    rng = np.random.default_rng(0)
    for day in range(2):
        rows = ["\t".join([str(int(rng.random() < 0.3)),
                           *(str(v) for v in rng.integers(0, 9, 13)),
                           *(format(int(v), "x") for v in rng.integers(0, 99, 26))])
                for _ in range(300)]
        (tmp_path / f"day_{day}.txt").write_text("\n".join(rows) + "\n")
    monkeypatch.setattr(cli, "CriteoStream", functools.partial(cli.CriteoStream,
                                                               cat_buckets=1 << 10))
    res = cli.main(["ctr", "--model", "dlrm", "--bf16", "--embedding-optimizer", "fused_adam",
                    "--data", str(tmp_path / "day_*.txt"), "--stream", "--batch-size", "128",
                    "--epochs", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"epoch 2/2 loss=[0-9.]+\nfinal train loss: [0-9.]+\n$", out), out
    assert len(res["loss"]) == 2 and np.isfinite(res["loss"]).all()


def test_bf16_is_refused_outside_dlrm():
    with pytest.raises(SystemExit, match="--model dlrm"):
        cli.main(["ctr", "--model", "fm", "--bf16", "--device", "cpu"])


def test_entry_points_import_neither_jax_nor_the_jax_package():
    code = ("import sys, recsys_tpu_torch.cli, recsys_tpu_torch.tools.protocol, "
            "recsys_tpu_torch.models.match.mind, recsys_tpu_torch.models.match.two_tower, "
            "recsys_tpu_torch.models.match.fm_match, recsys_tpu_torch.train.export, "
            "recsys_tpu_torch.data.movielens, recsys_tpu_torch.data.realistic, "
            "recsys_tpu_torch.data.amazon, recsys_tpu_torch.data.census, "
            "recsys_tpu_torch.models.match.ncf, recsys_tpu_torch.models.ctr.din, "
            "recsys_tpu_torch.models.ctr.esmm, recsys_tpu_torch.models.ctr.mmoe, "
            "recsys_tpu_torch.models.ctr.ple, recsys_tpu_torch.data.criteo, "
            "recsys_tpu_torch.data.streaming, recsys_tpu_torch.data.native, "
            "recsys_tpu_torch.train.checkpoint, recsys_tpu_torch.parallel.mesh, "
            "recsys_tpu_torch.parallel.sharding_rules, "
            "recsys_tpu_torch.parallel.embedding_sharding, recsys_tpu_torch.parallel.spawn, "
            "recsys_tpu_torch.tools.mesh_check, recsys_tpu_torch.train.retrieval, "
            "recsys_tpu_torch.train.streaming_embed, recsys_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'recsys_tpu', 'pandas')]; print(bad); "
            "sys.exit(bool(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
