"""The port's copies of the JAX package's modules that only its tests call:
``core/config.py`` (a config file written by either package loads in the
other), ``train/profiling.py`` (``trace``, with the program's spans),
``losses.l2_regularization`` and ``data/synthetic.py::synthetic_sequence``,
each against the JAX one on the CPU."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core import config as jax_config
from recsys_tpu.data.synthetic import synthetic_sequence as jax_synthetic_sequence
from recsys_tpu.train import losses as jax_losses
from recsys_tpu_torch.core import config
from recsys_tpu_torch.data.synthetic import synthetic_sequence
from recsys_tpu_torch.train import losses, profiling

REPO = Path(__file__).resolve().parents[1]


def test_config_fields_and_defaults_are_the_jax_packages():
    got = [(f.name, f.default) for f in dataclasses.fields(config.ExperimentConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jax_config.ExperimentConfig)]
    assert got == want


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_round_trips_across_the_packages(tmp_path, writer):
    kw = dict(task="sasrec", model="dlrm", epochs=3, learning_rate=5e-4,
              early_stopping_patience=None, embedding_optimizer="fused_adam",
              bf16_compute=True, data_path="day_*.txt")
    path = str(tmp_path / "exp.json")
    (config if writer == "port" else jax_config).ExperimentConfig(**kw).to_json(path)
    port = config.load_config(path, batch_size=1024)
    jax_cfg = jax_config.load_config(path, batch_size=1024)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert port.task == "sasrec" and port.batch_size == 1024 and port.epochs == 3
    assert port.early_stopping_patience is None  # a JSON null stays None
    assert port.override(seed=None, epochs=7).epochs == 7 and port.seed == 0
    doc = json.loads(Path(path).read_text())
    Path(path).write_text(json.dumps(dict(doc, nope=1)))
    with pytest.raises(ValueError, match="nope"):
        config.load_config(path)


def test_l2_regularization_matches_jax():
    """Over a module's parameters and over a list of tensors, within 1e-6
    relative of the JAX penalty over the same arrays."""
    rng = np.random.default_rng(0)
    module = torch.nn.Sequential(torch.nn.Linear(7, 5), torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    arrays = [p.detach().numpy().copy() for p in module.parameters()]
    want = float(jax_losses.l2_regularization({f"p{i}": jnp.asarray(a)
                                               for i, a in enumerate(arrays)}, 1e-3))
    got = losses.l2_regularization(module, 1e-3)
    assert got.requires_grad
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    np.testing.assert_allclose(float(losses.l2_regularization(
        [torch.from_numpy(a) for a in arrays], 1e-3)), want, rtol=1e-6)
    assert float(losses.l2_regularization([], 1.0)) == 0.0


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    """The program's spans land in ``trace.json`` on the profiler's time
    axis: the span brackets the matmul it ran."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("prep span", step=4) as sp:
            torch.ones(64, 64) @ torch.ones(64, 64)
            sp.count(rows=64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (got,) = [e for e in events if e.get("name") == "prep span"]
    assert got["cat"] == "span" and got["args"] == {"step": 4, "parent": None, "rows": 64}
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert got["tid"] == mm["tid"] and got["pid"] == mm["pid"]
    assert got["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= got["ts"] + got["dur"]
    assert profiling.span("after") is profiling.OFF


def test_synthetic_sequence_is_bit_equal_to_jax():
    schema, data = synthetic_sequence(num_examples=300, num_items=40, max_len=12, seed=4)
    jschema, want = jax_synthetic_sequence(num_examples=300, num_items=40, max_len=12, seed=4)
    assert data.keys() == want.keys()
    for k in want:
        assert data[k].dtype == want[k].dtype
        np.testing.assert_array_equal(data[k], want[k], err_msg=k)
    assert [(f.name, f.vocab_size, f.max_len, f.shared_with) for f in schema.varlen] == \
        [(f.name, f.vocab_size, f.max_len, f.shared_with) for f in jschema.varlen]
    assert [(f.name, f.vocab_size) for f in schema.sparse] == \
        [(f.name, f.vocab_size) for f in jschema.sparse]


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, recsys_tpu_torch.core.config, recsys_tpu_torch.train.profiling, "
            "recsys_tpu_torch.data.native, recsys_tpu_torch.train.streaming_embed, "
            "recsys_tpu_torch.tools.prep_sweep; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'recsys_tpu')]; print(bad); sys.exit(bool(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
