"""The traced sub-window: its window runs from the first mark to the
second, around exactly the steps asked for, and the busy time is the
union of the device intervals inside it."""
import pytest
import torch

from benchkit import devtrace


def test_the_window_holds_the_steps_between_the_marks():
    calls = []

    def step(k):
        calls.append(k)
        with torch.profiler.record_function(f"step{k}"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    tr = devtrace.profile_steps(step, 4, torch.device("cpu"), host_ops=True)
    assert calls == [0, 1, 2, 3, 4] and tr.steps == 4
    lo, hi = tr.window
    inside = {n for n, s, e in tr.host if n.startswith("step") and lo <= s < hi}
    assert inside == {"step1", "step2", "step3", "step4"}
    assert tr.window_s > 0


def test_busy_time_is_the_union_inside_the_window():
    events = [("k1", 0, 10), ("k2", 5, 20), ("k3", 30, 40), ("k4", 95, 130),
              ("lead", -50, -10)]
    tr = devtrace.Trace(events, [], (0, 100), 2)
    assert tr.busy_intervals() == [[0, 20], [30, 40], [95, 100]]
    assert tr.busy_s == pytest.approx(35e-9)
    assert tr.kernel_s(lambda n: n.startswith("k")) == pytest.approx(70e-9)
    assert [n for n, _ in tr.device_ops()] == ["k4", "k2", "k1", "k3"]
