"""The spans' arithmetic (``benchkit/spans.py``) on synthetic records: self
time is the duration less the children, and a gap in the device's
activity that crosses a span edge is split exactly there."""
import dataclasses

from benchkit import spans


@dataclasses.dataclass(eq=False)
class Rec:
    name: str
    start_ns: int
    end_ns: int
    parent: "Rec | None" = None


def test_self_time_is_the_duration_less_the_children():
    root = Rec("root", 0, 100)
    a, b = Rec("a", 10, 40, root), Rec("b", 50, 90, root)
    leaf = Rec("leaf", 15, 25, a)
    again = Rec("a", 200, 207)
    got = spans.self_times([leaf, a, b, root, again])
    assert got == {"root": 100 - 30 - 40, "a": 30 - 10 + 7, "b": 40, "leaf": 10}
    assert spans.self_times([]) == {}


def test_idle_by_span_splits_a_gap_at_the_span_edges():
    root = Rec("train_step", 100, 500)
    copy = Rec("train_step.copy", 150, 260, root)
    busy = [(0, 120), (200, 210), (400, 450), (900, 1200)]
    got = spans.idle_by_span([copy, root], busy, (50, 1000))
    # idle: [120, 200) split at 150; [210, 400) split at 260; [450, 900) at 500
    assert got == {"train_step": (150 - 120) + (400 - 260) + (500 - 450),
                   "train_step.copy": (200 - 150) + (260 - 210),
                   spans.BETWEEN: 900 - 500}
    assert sum(got.values()) == (1000 - 50) - 70 - 10 - 50 - 100
    assert spans.idle_by_span([], [], (0, 10)) == {spans.BETWEEN: 10}
