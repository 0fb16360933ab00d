"""The port's ``protocol ctr`` options ``--table-dtype`` and
``--embedding-lr`` (the JAX runner's semantics, ``recsys_tpu/tools/
protocol.py::run_ctr``) on the CPU, and the runner's bf16-table models
against the JAX ones from the same weights."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.cli import _ctr_model as jax_ctr_model
from recsys_tpu.data.realistic import realistic_criteo as jax_realistic_criteo
from recsys_tpu_torch.convert import ctr_params_from_jax
from recsys_tpu_torch.data.realistic import realistic_criteo
from recsys_tpu_torch.tools import protocol

# the bf16 tolerance of tests/test_torch_dlrm.py: the two frameworks round
# at different places, about one bf16 ulp of a logit
BF16_TOL = dict(rtol=1e-2, atol=2e-3)


@pytest.fixture
def trainers(monkeypatch):
    """The Trainers the runner builds, kept."""
    made = []

    class Kept(protocol.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(protocol, "Trainer", Kept)
    return made


def test_table_dtype_and_embedding_lr(tmp_path, trainers):
    out = tmp_path / "report.json"
    protocol.main(["ctr", "--rows", "3000", "--models", "fm,dlrm", "--epochs", "1",
                   "--table-dtype", "bf16", "--embedding-optimizer", "fused_adam",
                   "--embedding-lr", "0.02", "--device", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["table_dtype"] == "bf16" and rep["embedding_optimizer"] == "fused_adam"
    assert list(rep["models"]) == ["fm", "dlrm"]
    assert all(0.0 <= m["test_auc"] <= 1.0 for m in rep["models"].values())
    fm, dlrm = trainers[1:]  # the first is the process warm-up's DeepFM
    for tr in (fm, dlrm):
        assert tr.embedding_lr == 0.02 and tr.learning_rate == 1e-3
        assert {t.dtype for t in tr.tables().values()} == {torch.bfloat16}
        assert {s.dtype for st in tr.emb_state.values() for s in st.values()} == {torch.float32}
    assert dlrm.model.compute_dtype == torch.bfloat16


def test_f32_tables_and_embedding_lr_without_an_embedding_optimizer(trainers, capsys):
    """The report names no table dtype at f32, and an embedding rate
    without an embedding optimizer goes unused, as in the JAX runner."""
    protocol.main(["ctr", "--rows", "3000", "--models", "fm", "--epochs", "1",
                   "--embedding-lr", "0.02", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "table_dtype" not in rep and "embedding_optimizer" not in rep
    fm = trainers[-1]
    assert fm.embedding_optimizer is None and fm.embedding_lr == fm.learning_rate
    assert {p.dtype for p in fm.model.parameters()} == {torch.float32}
    with pytest.raises(SystemExit):
        protocol.main(["ctr", "--table-dtype", "f16", "--device", "cpu"])


@pytest.mark.parametrize("name", ["fm", "deepfm", "dlrm"])
def test_bf16_table_models_match_jax(name):
    """The runner's model at --table-dtype bf16 with fused Adam, and the JAX
    runner's, from the same weights: logits within the bf16 tolerance."""
    jschema, data, _ = jax_realistic_criteo(num_examples=64, embed_dim=8, seed=0)
    schema, data_t, _ = realistic_criteo(num_examples=64, embed_dim=8, seed=0)
    np.testing.assert_array_equal(data["sparse"], data_t["sparse"])
    kw = {"compute_dtype": jnp.bfloat16} if name == "dlrm" else {}
    kw.update(sparse_embed_grads=True, embed_kw={"param_dtype": jnp.bfloat16})
    jm = jax_ctr_model(name, jschema, **kw)
    batch = {k: v for k, v in data.items() if k != "label"}
    params = jm.init(jax.random.PRNGKey(0),
                     {k: jnp.asarray(v[:8]) for k, v in batch.items()})["params"]
    assert params["StackedEmbedding_0"]["table_0"].dtype == jnp.bfloat16
    tm = protocol.CTR_MODELS[name](schema, device="cpu",
                                   **protocol.ctr_model_kwargs(name, "fused_adam", "bf16"))
    assert tm.embedding.table_0.dtype == torch.bfloat16
    # bf16 values are exact in f32, and exact again in the port's bf16 tables
    tm.load_state_dict(ctr_params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), tm))
    want = np.asarray(jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()}),
                      np.float32)
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(v) for k, v in batch.items()}).float().numpy()
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_embedding_engine_runs_on_the_runners_mesh(trainers, capsys):
    """``--embedding-engine a2a`` on the JAX runner's mesh, (1, 1) in one
    process: every table through the engine, the report naming it and the
    ids it dropped (none at the default capacity on these rows)."""
    protocol.main(["ctr", "--rows", "3000", "--models", "dlrm", "--epochs", "1",
                   "--embedding-engine", "a2a", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["embedding_engine"] == "a2a" and 0.0 <= rep["models"]["dlrm"]["test_auc"] <= 1.0
    assert rep["a2a_dropped"] == {"dlrm": 0}
    dlrm = trainers[-1]
    assert dlrm.mesh.shape == {"data": 1, "model": 1}
    emb = dlrm.model.embedding
    assert emb.engine == "a2a" and sorted(emb.table_shards) == emb.groups()
