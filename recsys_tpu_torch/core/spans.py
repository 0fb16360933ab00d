"""The program's span recorder: host work timed at the layers' boundaries.

* ``span(name, step=None, **counts)``: a context manager around one piece
  of host work.  Off (the default) it returns the shared no-op ``OFF``
  after one global check: no clock read, no allocation of its own, no
  dispatcher or CUDA call.  On, it records a ``Span``: its name, its
  parent (the span open around it on the same thread), its step (``step``
  or, when None, the parent's), the thread, start and end in ns and its
  counts (``sp.count(k=n)`` adds to them).  A span never synchronises the
  card: it times what the host does, a blocking copy's wait included.
* ``recording()``: turns recording on for the block and yields the list
  the closed spans go into, in the order they close.

Spans stamp ``time.time_ns()``, the clock ``torch.profiler`` stamps its
events on, so a span and the device's activity in one trace share a time
axis (``train/profiling.py::trace`` writes them into one file).

The module imports nothing of the package, so every layer may open spans:
``Trainer.train_step`` (``train/loop.py``) opens its root and the steps'
phases, ``StackedEmbedding.forward`` (``ops/embedding.py``)
``embedding.gather``.
"""
from __future__ import annotations

import contextlib
import threading
import time

_sink = None  # the list the closed spans go into while recording, else None
_threads = threading.local()  # .stack: this thread's open spans, innermost last


class _Off:
    """The span returned while recording is off: it does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def count(self, **counts) -> None:
        pass


OFF = _Off()


class Span:
    """One recorded span; ``parent`` is the enclosing ``Span`` or None."""
    __slots__ = ("name", "parent", "step", "thread", "start_ns", "end_ns", "counts",
                 "_sink")

    def __init__(self, name: str, step, counts: dict, sink: list):
        self.name, self.step, self.counts, self._sink = name, step, counts, sink
        self.parent, self.thread, self.start_ns, self.end_ns = None, None, 0, 0

    def __enter__(self):
        stack = getattr(_threads, "stack", None)
        if stack is None:
            stack = _threads.stack = []
        self.parent = stack[-1] if stack else None
        if self.step is None and self.parent is not None:
            self.step = self.parent.step
        self.thread = threading.get_native_id()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _threads.stack.pop()
        self._sink.append(self)
        return False

    def count(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


def span(name: str, step=None, **counts):
    """A recorded ``Span`` while ``recording()`` is on, else ``OFF``."""
    sink = _sink
    if sink is None:
        return OFF
    return Span(name, step, counts, sink)


@contextlib.contextmanager
def recording():
    """Record every span opened in the block, on any thread; yields the
    list of closed spans.  A span still open when the block ends goes into
    the same list when it closes."""
    global _sink
    if _sink is not None:
        raise RuntimeError("spans are already being recorded")
    records = _sink = []
    try:
        yield records
    finally:
        _sink = None
