"""The span windows of a training cell (``span_windows.py``) on the CPU:
the small cell's windows A and B read the eight layer numbers, the
children cover the root, and the idle time put down to the spans adds up
to the window's."""
import pytest

import span_windows
from test_bench_faults import small_cell


def test_the_small_cell_reads_every_layer_and_splits_the_idle_time():
    out = span_windows.measure(small_cell(), 2**31 + 11, 0.2, "cpu")
    for k in span_windows.LAYERS:
        assert out[k] > 0.0, k
    # on the CPU the prep's arrays are numpy, so every copy blocks
    assert out["host.copy_blocking_pct"] == 100.0
    own = sum(out[k] for k in span_windows.LAYERS) + out["train_step_self_ms"]
    assert own == pytest.approx(out["train_step_span_ms"], rel=1e-9)
    assert 0.0 < out["children_cover_pct"] <= 100.0
    assert out["idle_by_span_sum_s"] == pytest.approx(out["idle_s"], rel=1e-12)
    names = [k for k, _ in out["idle_by_span"]]
    assert "train_step.forward" in names and out["device"] == "cpu"


def test_the_readers_give_nothing_without_spans():
    assert span_windows.read_spans([]) == {}


def test_the_blocking_share_counts_both_kinds_over_every_copy():
    from recsys_tpu_torch.train import profiling

    def rec(name, parent, s, e, **counts):
        r = profiling.Span(name, 1, counts, [])
        r.parent, r.start_ns, r.end_ns = parent, s, e
        return r

    roots = [rec("train_step", None, 0, 10_000_000), rec("train_step", None, 0, 20_000_000)]
    copies = [rec("train_step.copy", roots[0], 0, 4_000_000, bytes_blocking=3,
                  bytes_async=5),
              rec("train_step.copy", roots[1], 0, 2_000_000, bytes_blocking=1,
                  bytes_async=7)]
    out = span_windows.read_spans([*copies, *roots])
    assert out["host.copy_blocking_pct"] == pytest.approx(4 / 16 * 100)
    assert out["host.copy_ms"] == pytest.approx(3.0)
    assert out["train_step_self_ms"] == pytest.approx(12.0)
    assert out["children_cover_pct"] == pytest.approx(20.0)
    assert out["steps"] == 2 and out["host.prep_ms"] == 0.0


def test_the_names_it_reads_of_the_training_kind_are_there():
    """``span_windows.py`` reaches into ``kinds/train.py``: a change to
    these names or to ``_window``'s signature has to show here."""
    import inspect

    from benchkit import registry

    kind = registry.kind("train")
    assert isinstance(kind.CHECK_STEPS, int) and isinstance(kind.WARMUP_STEPS, int)
    assert isinstance(kind.TRACED_SECONDS, float) and kind.TRACED_SECONDS > 0
    assert list(inspect.signature(kind._window).parameters) == [
        "prog", "pool", "start", "seconds", "device"]
