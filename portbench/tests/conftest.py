"""Fixtures of the benchmark's tests: the cells at a size a CPU test run
holds (96x128 full images at scale 0.5, 20 labels, a pool of 3 frames),
and the ``card`` marker of tests that need a CUDA card."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import registry


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The card, for a test marked ``card``; skips without one (decided
    here, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(cell_name: str):
    """(config, traffic) of a cell, cut to a CPU test's size."""
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    config = copy.deepcopy(registry.config(cell["config"]))
    config["rig"].update(full_height=96, full_width=128, focal=150.0)
    config["settings"]["num_depth_levels"] = 20
    config["check_requests"] = 2
    traffic = copy.deepcopy(registry.traffic(cell["traffic"]))
    traffic.update(pool_frames=3, trace_seconds=0.5)
    return config, traffic


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
