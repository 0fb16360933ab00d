"""Finds a cell's pieces by name, as files under the benchmark's folder.

- ``workloads/<cell>.json``: the cell (its kind, configuration, traffic
  mix, batch, chips and correctness limits);
- ``kinds/<kind>.py``: how a cell of that kind runs (set-up, the measured
  window, its end-to-end metrics, the check), e.g. ``train``;
- ``configs/<config>.json``: the model's sizes, naming its ``family``;
- ``traffic/<mix>.json``: a mix's parameters, naming its ``generator``;
- ``generators/<name>.py``: makes a pool of inputs from a mix's parameters;
- ``laws/<law>.py``: draws values by one law a mix names (ids, features);
- ``models/<family>.py``: builds the system under test and its reference;
- ``metrics/<metric>.py``: a per-layer metric's reader;
- ``BENCHMARK.json`` at the checkout's root: which metrics each cell reports.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path} is missing)")
    return json.loads(path.read_text())


@functools.cache
def _module(path: Path):
    name = f"bench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # where dataclasses and pickling look a module up
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # the workload file
    config: dict
    traffic: dict

    @property
    def batch(self) -> int:
        return int(self.spec["batch"])

    @property
    def kind(self) -> str:
        return str(self.spec["kind"])

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def cell(name: str) -> Cell:
    spec = load_json("workloads", name)
    return Cell(name, spec, load_json("configs", spec["config"]),
                load_json("traffic", spec["traffic"]))


def _named(kind: str, folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r} ({path} is missing)")
    return _module(path)


def family(name: str):
    return _named("model family", "models", name)


def kind(name: str):
    return _named("cell kind", "kinds", name)


def generator(name: str):
    return _named("traffic generator", "generators", name)


def law(name: str):
    return _named("law", "laws", name)


def metric_readers() -> dict:
    """{metric name: module} of every reader under ``metrics/``."""
    return {p.stem: _module(p) for p in sorted((HERE / "metrics").glob("*.py"))}


def reported(cell_name: str) -> dict[str, list[str]]:
    """The metrics ``BENCHMARK.json`` has this cell report:
    ``{'end_to_end': [...], 'per_layer': [...]}``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {kind: [m["name"] for m in bench.get(kind, [])
                   if cell_name in m.get("workloads", [cell_name])]
            for kind in ("end_to_end", "per_layer")}
