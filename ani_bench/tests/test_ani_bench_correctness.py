"""What decides ``correct``: the plain reference agrees with the port,
the control (the reference in a lower precision, in the program's
place) fails a limit, and a run whose timed path is broken underneath
comes out not correct."""

import dataclasses

import pytest
import torch

from conftest import tiny_cell
from ani_bench.lib import harness

CELLS = ["derep_triangle-species", "derep_triangle-sketch"]


def _entry(name, seed=2**31 + 9, calls=2):
    cell = tiny_cell(name)
    entry = harness.load_entry(cell.traffic["entry"]).Entry(
        cell.config, cell.traffic, seed, "cpu")
    entry.setup()
    for _ in range(calls):
        entry.call()
    entry.release()
    return cell, entry


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_and_control_fails(name):
    cell, entry = _entry(name)
    limits = cell.traffic["limits"]
    got = entry.check()
    assert all(got[k] <= limits[k] for k in limits), got
    control = entry.check(control=True)
    assert any(control[k] > limits[k] for k in limits), control


def _run_broken(name, monkeypatch, target, wrap):
    module, attr = target
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    out = harness.run(tiny_cell(name), 2**31 + 3, 0.5, False, "cpu", 0.0,
                      log=lambda s: None)
    return out["correct"]


def _alter_pairs(triangle, half=False):
    def broken(*a, **kw):
        ri, qi, out = triangle(*a, **kw)
        out = dict(out)
        ani = out["ani_mean"].copy()
        if half:
            ani[len(ani) // 2:] = 0.0
        else:
            ani[:] = ani + 1e-3
        out["ani_mean"] = ani
        return ri, qi, out
    return broken


def _alter_sketch(sketch, half=False):
    def broken(items, *a, **kw):
        items = list(items)
        if half:
            cut = (len(items) + 1) // 2
            hosts = sketch(items[:cut], *a, **kw)
            hosts += [dataclasses.replace(hosts[i % cut], name=n)
                      for i, (n, _) in enumerate(items[cut:])]
            return hosts
        hosts = sketch(items, *a, **kw)
        for h in hosts:
            h.device.kmers[0] += 1
        return hosts
    return broken


@pytest.mark.parametrize("half", [False, True])
def test_broken_triangle_is_not_correct(half, monkeypatch):
    import pyskani_tpu_torch.engine.batch as batch
    assert not _run_broken("derep_triangle-species", monkeypatch,
                           (batch, "triangle"),
                           lambda f: _alter_pairs(f, half))


@pytest.mark.parametrize("half", [False, True])
def test_broken_sketch_is_not_correct(half, monkeypatch):
    import pyskani_tpu_torch.database as db
    assert not _run_broken("derep_triangle-sketch", monkeypatch,
                           (db, "sketch_genomes_device"),
                           lambda f: _alter_sketch(f, half))


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short traced run of the triangle cell on the card (the chip
    command in ani_bench/README.md runs this file there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's DP kernel is CUDA only")
    out = harness.run(tiny_cell("derep_triangle-species"), 7, 1.0, True,
                      "cuda:0", 0.0, log=lambda s: None)
    assert out["correct"] and out["device"]["busy_s"] > 0
