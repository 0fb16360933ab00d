"""What the profiler's trace of a traced sub-window says: the device's
activity (kernels, copies, sets), its busy time as the union of those
intervals, each kernel's time by name, and the idle gaps between them
with the host work under each.

The sub-window is a run of steps between two marks: a lead step, then a
mark, the steps, a mark.  On a card a mark is a spin kernel of no length
(``torch.cuda._sleep(0)``) on the step's stream, so the window runs on the
device's own clock from the first mark's start to the second's: the
device's period of exactly those steps, with the idle before and between
them, and without the synchronize or the profiler's start.  On the CPU
(tests) the marks are host spans.

Two kinds of sub-window: one that traces the device alone, whose timing
the metrics read (tracing every host op as well doubles a host-bound
step), and one that traces the host's ops too, only to name the host work
under each idle gap.  Everything is read from ``torch.profiler``'s Kineto
events in memory; nothing is written to disk.
"""
from __future__ import annotations

import collections
import dataclasses
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.mark"  # the host span around each mark
MARK_KERNEL = re.compile(r"\bspin_kernel\b")  # the kernel ``torch.cuda._sleep`` launches
STEP = "bench.train_step"  # the span around each traced call, with host ops
TOP = 10  # entries in each list of the breakdown


@dataclasses.dataclass
class Trace:
    device: list  # (name, start_ns, end_ns) of each kernel, copy and set but the marks
    host: list  # (name, start_ns, end_ns) of each host op, runtime call and span
    window: tuple  # (start_ns, end_ns): from the first mark's start to the second's
    steps: int  # the steps inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device intervals inside the window, merged."""
        lo, hi = self.window
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, match) -> float:
        """Seconds of the device events inside the window whose name
        ``match(name)`` accepts."""
        lo, hi = self.window
        return sum(e - s for n, s, e in self.device if lo <= s < hi and match(n)) * 1e-9

    def device_ops(self) -> list:
        """[name, seconds] of the device ops inside the window that took
        most time."""
        lo, hi = self.window
        ops = collections.Counter()
        for n, s, e in self.device:
            if lo <= s < hi:
                ops[n[:160]] += (e - s) * 1e-9
        return [[n, v] for n, v in ops.most_common(TOP)]

    def idle_gaps(self) -> list:
        """[host work, seconds] of the longest idle time, each gap named by
        the innermost host op or span under its middle (a trace with host
        ops only)."""
        gaps = collections.Counter()
        busy = self.busy_intervals()
        edges = [self.window[0], *[x for iv in busy for x in iv], self.window[1]]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                gaps[self.host_at((s + e) // 2)] += (e - s) * 1e-9
        return [[n, v] for n, v in gaps.most_common(TOP)]

    def host_at(self, t: int) -> str:
        inner = None
        for n, s, e in self.host:
            if s <= t < e and (inner is None or e - s < inner[2] - inner[1]):
                inner = (n, s, e)
        if inner is None:
            return "host: between steps"
        if inner[0] == STEP:
            return "host: train_step outside any traced op (Python, native prep)"
        return f"host: {inner[0][:120]}"


def _mark(cuda: bool) -> None:
    with record_function(MARK):
        if cuda:
            torch.cuda._sleep(0)


def profile_steps(step, n: int, device: torch.device, host_ops: bool = False) -> Trace:
    """Profile ``step(0)`` (the lead step, outside the window) and then
    ``step(1)`` .. ``step(n)`` between two marks: on a card its device
    activity, and with ``host_ops`` (or on the CPU) the host's ops too,
    each step inside a ``STEP`` span."""
    cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CUDA] if cuda else []) + \
        ([ProfilerActivity.CPU] if host_ops or not cuda else [])
    with profile(activities=acts) as prof:
        step(0)
        _mark(cuda)
        for k in range(1, n + 1):
            if host_ops:
                with record_function(STEP):
                    step(k)
            else:
                step(k)
        _mark(cuda)
        if cuda:
            torch.cuda.synchronize(device)
    dev, host, device_marks, host_marks = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == torch.autograd.DeviceType.CPU:
            (host_marks if iv[0] == MARK else host).append(iv)
        elif _kind(e) in DEVICE_KINDS:
            (device_marks if MARK_KERNEL.search(iv[0]) else dev).append(iv)
    marks = sorted(device_marks if cuda else host_marks, key=lambda x: x[1])
    if len(marks) != 2:
        raise RuntimeError(f"the profiler recorded {len(marks)} window marks, not 2")
    return Trace(dev, host, (marks[0][1], marks[1][1]), n)


def _kind(e) -> str:
    """A device event's Kineto activity type: read where the event says it
    (newer torch), else ``gpu_user_annotation`` for a span mirrored on the
    device and ``kernel`` for the rest (kernels, copies and sets)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    return "kernel"
