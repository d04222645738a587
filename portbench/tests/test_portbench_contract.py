"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its files."""

from __future__ import annotations

import json
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == TOP
    raw = (registry.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_full_check_fits(bench):
    # 24 cells: 2 + 14 x 24 runs, each run_seconds + 60 s, 2 x 90 s a cell
    # to compile, 1,200 s spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in bench[kind]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = json.loads((registry.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    configs = {c["name"] for c in bench["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line(w["why"])
        registry.traffic(w["traffic"])
        for c in registry.limits(w["name"]).values():
            # between its readings, with at least as much room above the
            # lower, by ratio, as below the upper
            assert c["lower"] < c["limit"] < c["upper"]
            assert c["limit"] ** 2 >= c["lower"] * c["upper"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        registry.e2e_reader(m["name"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        registry.layer_reader(m["name"])
        layers.setdefault(m["layer"], []).append(m["name"])
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(bench, w["name"], True)
