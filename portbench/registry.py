"""Everything of a cell is found by name under ``portbench/``.

* ``BENCHMARK.json`` (the checkout's root): the cells, and which metrics
  each reports;
* ``configs/<config>.json``: the rig, the engine's settings, the engine and
  reference by name, how many answers a run checks;
* ``traffic/<mix>.json``: the flow, the loop, the frame pool;
* ``engines/<engine>.py``: how a request calls the program;
* ``reference/<reference>.py``: the plain reference of that engine;
* ``e2e/<metric>.py`` and ``layers/<metric>.py``: one reader a metric;
* ``limits/<cell>.json``: the limit of each number the check compares.

A new configuration, mix, cell or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} file {path.relative_to(ROOT)}")
    qual = f"portbench.{kind}.{name.replace('.', '__')}"
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engine(name: str):
    return importlib.import_module(f"portbench.engines.{name}")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def e2e_reader(name: str):
    return _module("e2e", name)


def layer_reader(name: str):
    return _module("layers", name)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, trace: bool):
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]
