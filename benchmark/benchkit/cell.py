"""One run of one cell: the cell's kind (``kinds/<kind>.py``) sets up,
measures and reads what its check compares; this module picks the metrics
that ``BENCHMARK.json`` has the cell report, judges the check against the
cell's limits and makes the result line's object.

A kind's ``run(cell, seed, seconds, trace, device, process_start, log)``
returns an ``Outcome``.  It calls ``guard.check()`` once its set-up has
ended; this module calls it again once the window has closed.
"""
from __future__ import annotations

import dataclasses
import sys

from benchkit import compare, guard, registry


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # {metric: (value, unit)}, every end-to-end metric the kind measures
    context: object  # what the per-layer metrics' readers read
    device: dict  # the result line's ``device``
    breakdown: dict | None  # the result line's ``breakdown``, with a trace on a card
    found: dict  # {number: (value, where)}, every number the check reads


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool, device,
             process_start: float, log=sys.stderr) -> dict:
    """The result line's object for one run (see ``run.py``)."""
    out = registry.kind(cell.kind).run(cell, seed, seconds, trace, device, process_start, log)
    correct, checks = compare.judge(out.found, cell.spec["limits"])

    wanted = registry.reported(cell.name)
    metrics = {}
    if not trace:
        metrics = {k: {"value": out.end_to_end[k][0], "unit": out.end_to_end[k][1]}
                   for k in wanted["end_to_end"] if k in out.end_to_end}
    else:
        readers = registry.metric_readers()
        for k in wanted["per_layer"]:
            value = readers[k].read(out.context) if k in readers else None
            if value is not None:
                metrics[k] = {"value": value, "unit": readers[k].UNIT}

    guard.check()
    result = {"correct": correct, "attempted": len(checks),
              "failed": sum(not (c["value"] <= c["limit"]) for c in checks.values()),
              "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, (v, at) in out.found.items():
        if k not in checks:
            print(f"reading {k} {v!r} (at {at}; not compared)", file=log)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"({'pass' if c['value'] <= c['limit'] else 'FAIL'}, worst at {c['at']})",
              file=log)
    return result
