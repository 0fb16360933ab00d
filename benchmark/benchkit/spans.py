"""What the program's spans say (``recsys_tpu_torch/core/spans.py``): each
span's self time, and a device trace's idle time put down to the span it
falls under.  The arithmetic lives here, beside the metrics that read it,
so the program records and the benchmark decides what a number means.

A record is anything with ``name``, ``parent`` (a record or None),
``start_ns`` and ``end_ns``, as the program's ``Span`` has.
"""
from __future__ import annotations

import collections

BETWEEN = "between steps"  # ``idle_by_span``'s name for idle time under no span


def self_times(records) -> dict:
    """{span name: ns}: each record's duration less its children's (the
    spans whose parent it is), summed by name."""
    out = collections.Counter()
    for r in records:
        out[r.name] += r.end_ns - r.start_ns
        if r.parent is not None:
            out[r.parent.name] -= r.end_ns - r.start_ns
    return dict(out)


def idle_by_span(records, busy, window) -> dict:
    """{span name: ns} of the device's idle time inside ``window`` (start,
    end ns), each idle stretch split at the span edges and put down to the
    innermost span over each part (the one opened last), ``BETWEEN`` where
    none is.  ``busy``: the device's busy intervals (start, end ns), sorted
    and disjoint.  The parts add up to the window less ``busy``."""
    lo, hi = window
    edges = sorted({lo, hi, *(min(max(t, lo), hi) for r in records
                               for t in (r.start_ns, r.end_ns)),
                    *(min(max(t, lo), hi) for iv in busy for t in iv)})
    opens = sorted(records, key=lambda r: r.start_ns)
    out = collections.Counter()
    active, i, b = [], 0, 0
    for a, z in zip(edges, edges[1:]):
        while i < len(opens) and opens[i].start_ns <= a:
            active.append(opens[i])
            i += 1
        active = [r for r in active if r.end_ns > a]
        while b < len(busy) and busy[b][1] <= a:
            b += 1
        if b < len(busy) and busy[b][0] <= a:
            continue  # the device is busy over [a, z)
        inner = max(active, key=lambda r: r.start_ns, default=None)
        out[inner.name if inner is not None else BETWEEN] += z - a
    return dict(out)
