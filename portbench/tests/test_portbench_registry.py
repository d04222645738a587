"""Configurations, mixes and metrics are found by name: a new one is a new
file and a new entry, with no edit elsewhere."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import registry


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """A copy of the benchmark whose registry reads the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root)
    monkeypatch.setattr(registry, "HERE", root / "portbench")
    monkeypatch.setattr(registry, "ROOT", root)
    return root


def test_cells_find_their_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        config = registry.config(w["config"])
        assert registry.engine(config["engine"]).build
        assert registry.reference(config["reference"]).depth_maps
        assert registry.traffic(w["traffic"])["flow"] in ("wta", "mrf")
        assert "mismatch_pct" in registry.limits(w["name"])
    for m in bench["end_to_end"]:
        assert registry.e2e_reader(m["name"]).read
    for m in bench["per_layer"]:
        assert registry.layer_reader(m["name"]).read


def test_a_new_cell_and_metric_are_files_and_entries(copy):
    pb = copy / "portbench"
    cfg = json.loads((pb / "configs/refr_pair_r5.json").read_text())
    cfg.update(name="refr_pair_r7")
    cfg["settings"]["window_radius"] = 7
    (pb / "configs/refr_pair_r7.json").write_text(json.dumps(cfg))
    (pb / "traffic/burst.json").write_text(
        (pb / "traffic/wta.json").read_text())
    (pb / "limits/refr_pair_r7.burst.json").write_text(
        '{"mismatch_pct": {"limit": 0.5}}')
    (pb / "layers/requests_traced.pair.py").write_text(
        "def read(run):\n    return run.traced_requests\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "refr_pair_r7.burst",
                               "config": "refr_pair_r7", "traffic": "burst",
                               "chips": 1, "why": "wider windows"})
    bench["per_layer"].append({
        "name": "requests_traced.pair", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "device",
        "moves": "pair_per_s", "workloads": ["refr_pair_r7.burst"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.benchmark()
    cell = registry.cell(bench, "refr_pair_r7.burst")
    assert registry.config(cell["config"])["settings"]["window_radius"] == 7
    assert registry.traffic(cell["traffic"])["pool_frames"] > 0
    names = [m["name"] for m in registry.metrics_of(bench, cell["name"],
                                                    True)]
    assert names == ["requests_traced.pair"]
    reader = registry.layer_reader("requests_traced.pair")
    assert reader.read(type("R", (), {"traced_requests": 3})) == 3


def test_unknown_names_are_refused():
    with pytest.raises(LookupError):
        registry.config("no_such_config")
    with pytest.raises(LookupError):
        registry.layer_reader("no_such_metric")
    with pytest.raises(LookupError):
        registry.cell(registry.benchmark(), "no.such")
