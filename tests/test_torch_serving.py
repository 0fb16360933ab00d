"""Port serving surface (recsys_tpu_torch.train) against the JAX Trainer:
``predict`` with a remainder batch, the consumer path, ``evaluate_auc``,
the metrics and the prefetch thread.  JAX stays on the CPU."""
import numpy as np
import pytest
import torch

from recsys_tpu.train import metrics as jax_metrics
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.data.prefetch import prefetch
from recsys_tpu_torch.train import metrics
from recsys_tpu_torch.train.loop import Trainer
from test_torch_dlrm import TOL, build_pair


def _jax_trainer(jm, params, data):
    tr = JaxTrainer(jm)
    tr.init({k: v[:8] for k, v in data.items()})
    tr.state = tr.state.replace(params=params)
    return tr


@pytest.mark.parametrize("compute, fused, nm", [("f32", False, 1), ("bf16", True, 4)])
def test_predict_with_remainder_matches_jax(compute, fused, nm):
    jm, params, tm, data = build_pair(compute, fused, nm, num_examples=200)
    want = _jax_trainer(jm, params, data).predict(data, batch_size=64)
    got = Trainer(tm, device="cpu").predict(data, batch_size=64)
    assert got.shape == (200,) == want.shape  # 3 full batches + 8 rows
    np.testing.assert_allclose(got, want, **TOL[compute])


def test_predict_consumer_gets_every_row_once_in_order():
    _, _, tm, data = build_pair(num_examples=150)
    tr = Trainer(tm, device="cpu")
    seen = []
    assert tr.predict(data, batch_size=64,
                      consumer=lambda out, start: seen.append((start, out))) is None
    assert [s for s, _ in seen] == [0, 64, 128]
    assert [len(o) for _, o in seen] == [64, 64, 22]
    np.testing.assert_array_equal(np.concatenate([o for _, o in seen]),
                                  tr.predict(data, batch_size=64))


def test_evaluate_auc_matches_jax():
    jm, params, tm, data = build_pair(num_examples=300, seed=3)
    want = _jax_trainer(jm, params, data).evaluate_auc(data, batch_size=128)
    got = Trainer(tm, device="cpu").evaluate_auc(data, batch_size=128)
    assert abs(got - want) < 1e-4, (got, want)


def test_trainer_without_a_card_or_device_raises(monkeypatch):
    _, _, tm, _ = build_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tm)


def test_predict_refuses_ids_outside_the_vocabulary():
    _, _, tm, data = build_pair(num_examples=40)
    data["sparse"][37, 2] = 1000  # vocab is 1000
    with pytest.raises(ValueError, match="outside"):
        Trainer(tm, device="cpu").predict(data, batch_size=16)


def test_auc_matches_jax_metrics():
    rng = np.random.default_rng(7)
    scores = rng.random(5000).astype(np.float32)
    labels = (rng.random(5000) < scores).astype(np.float32)
    assert abs(metrics.auc(scores, labels) - jax_metrics.auc(scores, labels)) < 1e-6
    assert metrics.auc_exact(scores, labels) == jax_metrics.auc_exact(scores, labels)
    assert metrics.auc(scores, np.ones_like(labels)) == 0.5
    # ties in the exact estimator take average ranks
    assert metrics.auc_exact([0.5, 0.5], [0, 1]) == 0.5


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(10)), depth=3)) == list(range(10))

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(prefetch(broken()))
