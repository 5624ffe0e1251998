"""Shared helpers of the benchmark's CPU tests: cells of BENCHMARK.json
shrunk to sizes a CPU run holds in seconds."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ani_bench.lib import harness  # noqa: E402


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` with its population, pool and cycle cut down."""
    cell = harness.find_cell(harness.load_benchmark(), name)
    pop = cell.config["population"]
    pop.update(root_bp=[120000, 200000, 300000], contigs=[1, 5])
    entry = cell.traffic["entry"]
    if entry == "triangle":
        pop.update(roots=2, children=10)
        cell.traffic.update(cycle=[[4, 2], [10, 1]], sample=12,
                            sample_block=4)
    else:
        pop.update(children=3)
        cell.traffic.update(roots=2, sample=3)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
