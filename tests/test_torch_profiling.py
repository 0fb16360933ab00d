"""The port's span recorder (``core/spans.py``, named in
``train/profiling.py`` too) on the CPU: a span off is the shared no-op,
spans nest by thread and carry their step, a span open when recording
ends still lands, the ops layer's ``embedding.gather`` on its own, the
spans and copy counts of ``Trainer.train_step`` and ``fit``, and the
clock the profiler stamps its events on."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recsys_tpu_torch.core import spans
from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.train import profiling
from recsys_tpu_torch.train.loop import Trainer

CHILDREN = ["train_step.prep", "train_step.copy", "train_step.dense_adam",
            "train_step.forward", "train_step.backward", "train_step.dense_adam",
            "train_step.embed_update"]


def _trainer(n=96):
    schema, data = synthetic_ctr(num_examples=n, num_dense=4, num_sparse=5, vocab_size=64,
                                 embed_dim=8, seed=3)
    torch.manual_seed(0)
    model = DLRM(schema, bottom_units=(16, 8), top_units=(16,), sparse_embed_grads=True,
                 device="cpu")
    return Trainer(model, embedding_optimizer="fused_adam", device="cpu"), data


def test_a_span_off_is_the_shared_no_op_and_records_nothing():
    assert profiling.span("x", step=3, n=1) is profiling.OFF
    with profiling.span("x") as sp:
        sp.count(bytes_blocking=8)
    with profiling.recording() as records:
        assert isinstance(profiling.span("y"), profiling.Span)
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
    assert records == []  # a span made but never opened records nothing
    assert profiling.span("z") is profiling.OFF


def test_a_span_off_costs_under_a_microsecond():
    span, n, best = profiling.span, 500, float("inf")
    for _ in range(100):  # the least of short runs: the cost without the load
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("train_step.copy"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    assert best < 1000.0, best


def test_spans_nest_with_parent_step_and_thread_across_two_threads():
    def other():
        with profiling.span("other", step=7):
            with profiling.span("other.inner") as sp:
                sp.count(rows=2)
                sp.count(rows=3)

    with profiling.recording() as records:
        with profiling.span("root", step=5):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with profiling.span("root.inner", n=1):
                pass
    assert not t.is_alive()
    by = {r.name: r for r in records}
    assert sorted(by) == ["other", "other.inner", "root", "root.inner"]
    assert by["root"].parent is None and by["root.inner"].parent is by["root"]
    assert by["other"].parent is None and by["other.inner"].parent is by["other"]
    assert (by["root.inner"].step, by["other.inner"].step) == (5, 7)
    assert by["root"].thread == by["root.inner"].thread == threading.get_native_id()
    assert by["other"].thread == by["other.inner"].thread != by["root"].thread
    assert by["other.inner"].counts == {"rows": 5} and by["root.inner"].counts == {"n": 1}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns <= r.parent.end_ns


def test_a_train_step_records_one_root_with_its_children():
    tt, data = _trainer()
    batches = [{k: v[i * 32:(i + 1) * 32] for k, v in data.items()} for i in range(2)]
    with profiling.recording() as records:
        for b in batches:
            tt.train_step(b)
    roots = [r for r in records if r.parent is None]
    assert [(r.name, r.step) for r in roots] == [("train_step", 1), ("train_step", 2)]
    for root in roots:
        kids = sorted((r for r in records if r.parent is root), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == CHILDREN
        assert all(r.step == root.step for r in kids)
        fwd = next(r for r in kids if r.name == "train_step.forward")
        gathers = [r for r in records if r.name == "embedding.gather" and r.parent is fwd]
        assert len(gathers) == 1 and gathers[0].step == root.step
    assert len(records) == 2 * (1 + len(CHILDREN) + 1)


def test_the_copy_counts_are_the_arrays_nbytes_by_kind():
    """Numpy arrays go by blocking copies, tensors (the prep's, pinned on a
    card) ``non_blocking``; a train step counts every array it copies."""
    tt, data = _trainer()
    mixed = {"sparse": data["sparse"][:5], "label": data["label"][:5],
             "embaux0_ids": torch.zeros(7, 1, dtype=torch.int32),
             "embaux0_src": torch.zeros(9, dtype=torch.int32), "_rows": np.zeros(64)}
    with profiling.recording() as records:
        with profiling.span("copy") as sp:
            out = tt._to_device(mixed, sp)
    assert sorted(out) == ["embaux0_ids", "embaux0_src", "label", "sparse"]
    assert records[0].counts == {"bytes_blocking": data["sparse"][:5].nbytes + 5 * 4,
                                 "bytes_async": 7 * 4 + 9 * 4}

    batch = {k: v[:32] for k, v in data.items()}
    prep = tt._prep(batch["sparse"])  # numpy on the CPU, so blocking here
    with profiling.recording() as records:
        tt.train_step(batch)
    (copy,) = [r for r in records if r.name == "train_step.copy"]
    assert copy.counts == {"bytes_async": 0, "bytes_blocking": sum(
        np.asarray(v).nbytes for v in [*batch.values(), *prep.values()])}


def test_fit_records_the_prep_on_the_prefetch_thread():
    tt, data = _trainer()
    with profiling.recording() as records:
        tt.fit(data, batch_size=32, epochs=1, verbose=False)
    roots = [r for r in records if r.name == "train_step"]
    preps = [r for r in records if r.name == "train_step.prep"]
    assert [r.step for r in roots] == [1, 2, 3] and len(preps) == 3
    assert all(r.parent is None and r.step is None for r in preps)
    assert {r.thread for r in preps}.isdisjoint({r.thread for r in roots})


def test_a_span_brackets_the_profilers_op_on_one_clock():
    with profiling.recording() as records, profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (sp,) = records
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert sp.start_ns <= mm.start_ns() <= mm.end_ns() <= sp.end_ns


def test_a_span_open_when_recording_ends_lands_in_the_same_list():
    assert profiling.span is spans.span and profiling.OFF is spans.OFF
    with spans.recording() as records:
        late = spans.span("late", step=9)
        late.__enter__()
    assert records == [] and spans.span("after") is spans.OFF
    with spans.span("after"):  # off: records nothing, nests under nothing
        pass
    late.__exit__(None, None, None)
    assert records == [late] and late.parent is None and late.step == 9
    assert late.start_ns <= late.end_ns


def test_the_ops_layer_records_its_gather_outside_a_train_step():
    schema = FeatureSchema(sparse=[SparseFeature("a", 32, 4), SparseFeature("b", 16, 4)])
    torch.manual_seed(0)
    emb = StackedEmbedding(schema, device="cpu")
    ids = torch.tensor([[1, 2], [3, 4], [5, 6]])
    with spans.recording() as records:
        with spans.span("outer", step=3):
            out = emb(ids)
    assert out.shape == (3, 2, 4)
    gather, outer = records
    assert (gather.name, gather.parent, gather.step) == ("embedding.gather", outer, 3)
    assert outer.start_ns <= gather.start_ns <= gather.end_ns <= outer.end_ns
