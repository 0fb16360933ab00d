"""A training cell: one run.

1. Set-up: the traffic pool from the seed, the program with the
   benchmark's weights, the checked first steps (through the timed call,
   on the pool's first batches), then warm-up steps on the next ones.
2. The measured window: the family's step on the pool's batches in order
   for ``seconds`` of host time, a CUDA event recorded after each call,
   then ``torch.cuda.synchronize()``.
3. With ``trace``: a short sub-window of further steps under the profiler
   (``devtrace``), and a shorter one with the host's ops.
4. The program is freed; the plain reference runs the checked steps from
   the same start, and the comparison (``compare``) gives the numbers that
   decide ``correct``.

``setup_s`` runs from the process's start to the first timed step.

The family module (``models/<family>.py``) gives ``dims``, ``Program``
(``marks``, ``step``, ``check_steps``) and ``reference_readings``; the
mix names its generator (``generators/<name>.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from benchkit import compare, devtrace, guard, peaks, registry
from benchkit.cell import Outcome
from benchkit.seeds import TRAFFIC, sub_seed

CHECK_STEPS = 3  # the first steps, which the reference follows
WARMUP_STEPS = 10  # steps after them, before the window opens
TRACED_SECONDS = 1.0  # the traced sub-window, at least 10 steps


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""
    config: dict
    batch: int
    call_ms: list  # host ms of each timed train_step call in the window
    step_s: float  # the untraced window's mean step on the device's clock
    trace: devtrace.Trace | None  # the device-only traced sub-window, on a card
    peaks: dict | None  # the card's published peaks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(prog, pool, start: int, seconds: float, device: torch.device):
    """Steps the pool from ``start`` for ``seconds``; returns (steps, host
    seconds to the final synchronize, each step's interval in ms, each
    call's host ms)."""
    cuda = device.type == "cuda"
    marks, call_ms = [], []
    _sync(device)
    t0 = time.perf_counter()
    if cuda:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        marks.append(first)
    else:
        marks.append(t0)
    i = start
    while True:
        c0 = time.perf_counter()
        prog.step(pool[i % len(pool)])
        c1 = time.perf_counter()
        i += 1
        call_ms.append((c1 - c0) * 1e3)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(c1)
        if c1 - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return i - start, elapsed, step_ms, call_ms


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool, device,
        process_start: float, log) -> Outcome:
    device = torch.device(device)
    fam = registry.family(cell.config["family"])
    dims = fam.dims(cell.config)
    n_check, n_warm = CHECK_STEPS, WARMUP_STEPS

    marks = [("start", process_start), ("imports", time.time())]
    pool = registry.generator(cell.traffic["generator"]).make_pool(
        cell.traffic, dims["rows"], dims["num_dense"], cell.batch, sub_seed(seed, TRAFFIC),
        device)
    if len(pool) < n_check + 1:
        raise ValueError(f"a pool of {len(pool)} batches holds no window after "
                         f"{n_check} checked steps")
    _sync(device)
    marks.append(("traffic", time.time()))
    prog = fam.Program(cell.config, seed, device)
    _sync(device)
    marks += [(f"program: {k}", t) for k, t in prog.marks]
    marks.append(("program", time.time()))
    readings = prog.check_steps(pool[:n_check])
    marks.append(("checked steps", time.time()))
    for k in range(n_warm):
        prog.step(pool[(n_check + k) % len(pool)])
    _sync(device)
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - process_start
    guard.check()
    print("set-up: " + ", ".join(f"{a} {t - s:.3f} s" for (_, s), (a, t)
                                 in zip(marks, marks[1:])), file=log)

    steps, elapsed, step_ms, call_ms = _window(prog, pool, n_check + n_warm, seconds, device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda
                else 0}
    step_s = sum(step_ms) / len(step_ms) * 1e-3
    print(f"window: {steps} steps of {cell.batch} in {elapsed:.6f} s; mean step ms by "
          f"quarter of the window: {[float(np.mean(q)) for q in np.array_split(step_ms, 4)]}",
          file=log)
    tr, breakdown = None, None
    if trace:
        # the metrics' sub-window traces the device alone; a shorter one
        # with the host's ops names the host work under the idle gaps
        n_traced = max(10, math.ceil(TRACED_SECONDS / step_s))
        at = n_check + n_warm + steps
        tr = devtrace.profile_steps(lambda k: prog.step(pool[(at + k) % len(pool)]),
                                    n_traced, device)
        at += n_traced + 1
        gaps = devtrace.profile_steps(lambda k: prog.step(pool[(at + k) % len(pool)]),
                                      max(5, n_traced // 4), device, host_ops=True)
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        print(f"traced: {n_traced} steps, {tr.window_s / n_traced * 1e3:.6f} ms a step "
              f"against {step_s * 1e3:.6f} untraced; device busy "
              f"{tr.busy_s / n_traced * 1e3:.6f} ms a step", file=log)
        if cuda:
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": gaps.idle_gaps()}

    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.time()
    ref = fam.reference_readings(cell.config, seed, pool[:n_check], device)
    print(f"reference: {time.time() - t_ref:.3f} s", file=log)

    return Outcome(
        end_to_end={
            "train_examples_per_s": (steps * cell.batch / elapsed, "examples/s"),
            "train_step_p95_ms": (float(np.percentile(step_ms, 95)), "ms"),
            "setup_s": (setup_s, "s"),
        },
        context=Context(cell.config, cell.batch, call_ms, step_s, tr if cuda else None,
                        peaks.spec(kind) if cuda else None),
        device=dev_info,
        breakdown=breakdown,
        found=compare.gaps(readings, ref),
    )
