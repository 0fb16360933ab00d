"""``Trainer.fit`` over a stream, ``evaluate_auc`` through the device
histogram, checkpoints and ``log_jsonl`` of the port's ``Trainer`` against
the JAX Trainer on the CPU: the same small DLRM (f32, from the same
weights) fed the same ``CriteoStream`` batches of a TSV file written here
from a seed."""
import json

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.data.streaming import CriteoStream as JaxCriteoStream
from recsys_tpu.models.ctr.dlrm import DLRM as JaxDLRM
from recsys_tpu.train.loop import Trainer as JaxTrainer
from recsys_tpu_torch.convert import params_from_jax
from recsys_tpu_torch.data.streaming import CriteoStream
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.train import checkpoint, metrics
from recsys_tpu_torch.train.loop import Trainer
from test_torch_training import _close_by_share

BUCKETS, DIM, BATCH, ROWS = 64, 4, 64, 320
TOWERS = dict(bottom_units=(8, DIM), top_units=(8,))
STREAM = dict(batch_size=BATCH, chunk_rows=100, cat_buckets=BUCKETS, embed_dim=DIM, seed=3)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    """A Criteo TSV whose label leans on C1, C2 and I1, so AUC can rise."""
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(ROWS):
        dense = rng.integers(0, 50, 13)
        cats = rng.integers(0, 40, 26)
        logit = 1.5 * (cats[0] % 2) - 1.5 * (cats[1] % 3 == 0) + dense[0] / 25 - 1
        label = int(rng.random() < 1 / (1 + np.exp(-logit)))
        d = [str(v) if rng.random() > 0.1 else "" for v in dense]
        c = [format(int(v), "x") if rng.random() > 0.05 else "" for v in cats]
        lines.append("\t".join([str(label), *d, *c]))
    path = tmp_path_factory.mktemp("stream") / "day_0.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _pair(tsv, embedding_optimizer=None):
    """(JAX trainer, port trainer) on one DLRM's weights."""
    jschema = JaxCriteoStream(tsv, **STREAM).schema
    schema = CriteoStream(tsv, **STREAM).schema
    sparse = embedding_optimizer is not None
    jm = JaxDLRM(jschema, sparse_embed_grads=sparse, **TOWERS)
    jt = JaxTrainer(jm, learning_rate=1e-2, embedding_optimizer=embedding_optimizer,
                    embedding_fused_bf16=False)
    sample = next(iter(JaxCriteoStream(tsv, **STREAM)))
    jt.init(sample)
    torch.manual_seed(0)
    tm = DLRM(schema, sparse_embed_grads=sparse, device="cpu", **TOWERS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                                       schema, tm))
    tt = Trainer(tm, learning_rate=1e-2, embedding_optimizer=embedding_optimizer,
                 embedding_fused_bf16=False, device="cpu")
    return jt, tt


@pytest.mark.parametrize("embedding_optimizer", [None, "lazy_adam", "fused_adam"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_over_a_stream_matches_jax(tsv, embedding_optimizer, shuffle):
    """Two epochs over a stream of 5 batches (320 rows, chunks of 100: rows
    carried across chunk ends), each side its own stream from pass 0 (the
    JAX Trainer is initialised before fit, so its fit reads no sample
    batch): the epoch losses within 1e-5, the parameters after within 1e-5
    but where Adam moves a near-zero gradient by its sign."""
    jt, tt = _pair(tsv, embedding_optimizer)
    kw = dict(STREAM, shuffle=shuffle)
    want = jt.fit(JaxCriteoStream(tsv, **kw), epochs=2, verbose=False)
    got = tt.fit(CriteoStream(tsv, **kw), epochs=2, verbose=False)
    assert tt.step == int(jt.state.step) == 10
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                          tt.model.schema, tt.model)
    sd = tt.model.state_dict()
    for name, w in ref.items():
        _close_by_share(name, sd[name].numpy(), w.numpy(), "f32")


def test_fit_takes_a_callable_stream_and_val_data(tsv):
    _, tt = _pair(tsv)
    stream = CriteoStream(tsv, **STREAM)
    val = next(iter(CriteoStream(tsv, **dict(STREAM, shuffle=False))))
    hist = tt.fit(lambda: iter(stream), epochs=1, val_data=val, verbose=False)
    assert len(hist["loss"]) == len(hist["val_loss"]) == 1 and tt.step == 5


def test_streaming_auc_matches_the_array_path_and_jax(tsv):
    """On the weights of one JAX fit (a fit of each side would differ by
    Adam's sign noise, which moves scores across bins): the histograms
    over a stream, over arrays and over arrays with a padded tail against
    the numpy AUC of the gathered predictions (the plain version) and
    against the JAX evaluate_auc over the same stream, within 1e-6."""
    jt, tt = _pair(tsv)
    kw = dict(STREAM, shuffle=False)
    jt.fit(JaxCriteoStream(tsv, **kw), epochs=1, verbose=False)
    tt.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.params), tt.model.schema, tt.model))
    rows = list(CriteoStream(tsv, **kw))
    arrays = {k: np.concatenate([b[k] for b in rows]) for k in rows[0]}
    got_stream = tt.evaluate_auc(CriteoStream(tsv, **kw))
    got_padded = tt.evaluate_auc(arrays, batch_size=100)  # a padded tail
    got_array = tt.evaluate_auc(arrays)
    plain = metrics.auc(torch.sigmoid(torch.from_numpy(tt.predict(arrays))).numpy(),
                        arrays["label"])
    want = jt.evaluate_auc(JaxCriteoStream(tsv, **kw))
    assert 0.5 < plain < 1.0
    for got in (got_stream, got_padded, got_array):
        assert abs(got - plain) <= 1e-6
    assert abs(got_stream - want) <= 1e-6


def test_device_histogram_matches_numpy():
    rng = np.random.default_rng(1)
    s = np.concatenate([rng.random(500), [0.0, 1.0, -0.5, 1.5, 0.5]]).astype(np.float32)
    y = (rng.random(len(s)) < 0.4).astype(np.float32)
    w = (rng.random(len(s)) < 0.9).astype(np.float32)
    pos, neg = metrics.auc_histogram_torch(torch.from_numpy(s), torch.from_numpy(y), 64,
                                           torch.from_numpy(w))
    want = metrics.auc_histogram(s, y, 64, weights=w)
    np.testing.assert_array_equal(pos.numpy(), want[0])
    np.testing.assert_array_equal(neg.numpy(), want[1])
    acc = metrics.AucAccumulator(64)
    acc.update(torch.from_numpy(s[:200]), torch.from_numpy(y[:200]))
    acc.update(torch.from_numpy(s[200:]), torch.from_numpy(y[200:]))
    assert acc.result() == metrics.auc_from_histogram(*metrics.auc_histogram(s, y, 64))


@pytest.mark.parametrize("embedding_optimizer", [None, "lazy_adam", "rowwise_adagrad",
                                                 "fused_adam", "fused_rowwise_adagrad"])
def test_checkpoint_round_trip_continues_bit_equal(tsv, tmp_path, embedding_optimizer):
    """fit one epoch with a checkpoint, restore it into a fresh Trainer and
    fit one more epoch on the same stream object: the model, the optimizer
    state and the table state equal those of two uninterrupted epochs."""
    _, whole = _pair(tsv, embedding_optimizer)
    _, first = _pair(tsv, embedding_optimizer)
    _, resumed = _pair(tsv, embedding_optimizer)
    with torch.no_grad():  # the resumed trainer starts from other weights
        for p in resumed.model.parameters():
            p.add_(0.5)
    whole.fit(CriteoStream(tsv, **STREAM), epochs=2, verbose=False)
    stream = CriteoStream(tsv, **STREAM)
    path = str(tmp_path / "ckpt" / "best.pt")
    first.fit(stream, epochs=1, checkpoint_path=path, verbose=False)
    checkpoint.restore(path, resumed)
    assert resumed.step == first.step == 5
    resumed.fit(stream, epochs=1, verbose=False)
    for name, w in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], w), name
    for name, st in (whole.emb_state or {}).items():
        for k, v in st.items():
            assert torch.equal(resumed.emb_state[name][k], v), f"{name}.{k}"
    for pw, pr in zip(whole.optimizer.state.values(), resumed.optimizer.state.values()):
        for k, v in pw.items():
            assert torch.equal(pr[k], v), k


def test_best_checkpointer_keeps_the_best(tsv, tmp_path):
    _, tt = _pair(tsv)
    path = str(tmp_path / "best.pt")
    keeper = checkpoint.BestCheckpointer(path)
    assert keeper.update(0.5, tt) and not keeper.update(0.6, tt) and keeper.best == 0.5
    with torch.no_grad():
        tt.model.top.layers[0].weight.add_(1.0)
    assert keeper.update(0.4, tt)
    state = torch.load(path, weights_only=True)
    assert torch.equal(state["model"]["top.layers.0.weight"], tt.model.top.layers[0].weight)
    with pytest.raises(ValueError, match="mode"):
        checkpoint.BestCheckpointer(path, mode="up")
    _, other = _pair(tsv, "lazy_adam")
    with pytest.raises(ValueError, match="embedding optimizer state"):
        checkpoint.restore(path, other)


def test_log_jsonl_records_and_log_every(tsv, tmp_path, capsys):
    """One ``log_jsonl`` record an epoch, and one printed line an epoch
    (the port logs no steps: ``log_every`` is not ported)."""
    _, tt = _pair(tsv)
    log = tmp_path / "log.jsonl"
    val = next(iter(CriteoStream(tsv, **dict(STREAM, shuffle=False))))
    hist = tt.fit(CriteoStream(tsv, **STREAM), epochs=2, val_data=val, log_jsonl=str(log))
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [sorted(r) for r in recs] == [["epoch", "epoch_seconds", "loss", "step",
                                          "val_loss"]] * 2
    assert [(r["epoch"], r["step"]) for r in recs] == [(1, 5), (2, 10)]
    assert [r["loss"] for r in recs] == hist["loss"]
    assert [r["val_loss"] for r in recs] == hist["val_loss"]
    out = capsys.readouterr().out.splitlines()
    assert [line.split(" ")[:2] for line in out] == [["epoch", "1/2"], ["epoch", "2/2"]]
    tt.fit(CriteoStream(tsv, **STREAM), epochs=1, log_jsonl=str(log), verbose=False)
    assert sorted(json.loads(log.read_text().splitlines()[-1])) == \
        ["epoch", "epoch_seconds", "loss", "step"]


def test_the_value_errors(tsv):
    _, tt = _pair(tsv)
    stream = CriteoStream(tsv, **STREAM)
    with pytest.raises(ValueError, match="validation_split needs a resident array dict"):
        tt.fit(stream, validation_split=0.1)
    with pytest.raises(ValueError, match="val_data must be a dict"):
        tt.fit(stream, val_data=stream)
    with pytest.raises(ValueError, match="not in"):
        Trainer(tt.model, embedding_optimizer="adagrad", device="cpu")
