"""BENCHMARK.json against the contract's shape, and every file a cell
names found by name."""

import json
import os
import re

import pytest

from conftest import ROOT
from ani_bench.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ani_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)


def test_names_units_and_entry_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for item in BENCH[group]:
            assert set(item) <= keys, item
            assert NAME.match(item["name"]) and item["name"] not in seen
            seen.add(item["name"])
            if "unit" in item:
                assert UNIT.match(item["unit"]) and \
                    item["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in item:
                assert 1 <= len(item[key]) <= 200
                assert "\n" not in item[key] and "\t" not in item[key]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(BENCH, cell)
    assert harness.load_entry(c.traffic["entry"]).Entry
    names = {m["name"] for m in c.metrics_e2e}
    assert "setup_s" in names and len(names) >= 2 and c.metrics_layer
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in c.metrics_e2e + c.metrics_layer:
        assert callable(harness.load_reader(m["name"]))
    for m in c.metrics_layer:
        assert m["moves"] in e2e and m["moves"] in names
    assert set(c.traffic["limits"]) and \
        all(v >= 0 for v in c.traffic["limits"].values())


def test_configs_are_used_and_their_files_hold_their_keys():
    used = {w["config"] for w in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        assert conf["name"] in used
        with open(os.path.join(ROOT, conf["file"])) as f:
            data = json.load(f)
        assert conf["file"].startswith("ani_bench/configs/")
        assert set(conf["reduced"]) <= set(data["reduced"]) and \
            all(k in data for k in conf["reduced"])


def test_metric_found_only_in_its_cells():
    sketch = harness.find_cell(BENCH, "derep_triangle-sketch")
    tri = harness.find_cell(BENCH, "derep_triangle-species")
    assert "sketch_mbp_per_s" in {m["name"] for m in sketch.metrics_e2e}
    assert "sketch_mbp_per_s" not in {m["name"] for m in tri.metrics_e2e}
    assert "chain_dp_roofline" in {m["name"] for m in tri.metrics_layer}
    assert "chain_dp_roofline" not in {m["name"] for m in sketch.metrics_layer}
