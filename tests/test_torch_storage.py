"""On-disk stores of the port vs the JAX package's.

The bytes are the JAX package's: one genome's ``sketch_to_bytes``, a
store's ``markers.bin`` and ``index.db`` are byte-equal across the
packages; a database saved by either opens in the other with equal hits,
in both formats; and the lifecycle cases of ``tests/test_database.py``
(which files appear at ``sketch()`` and at ``flush()`` time, the
exceptions, ``open`` / ``load`` round trips) hold for the port.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu.db import storage as jax_storage
from pyskani_tpu.ops.sketch import sketch_genome_device as jax_sketch
from pyskani_tpu.params import SketchParams as JaxParams
from pyskani_tpu_torch.db import storage
from pyskani_tpu_torch.ops.sketch import FIELDS, sketch_genome_device
from pyskani_tpu_torch.params import SketchParams

torch.set_num_threads(1)

FORMATS = ["consolidated", "separated"]


def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(43)
    base = random_genome(rng, 90_000)
    m = mutate(rng, base, 0.02)
    refs = [("near", [mutate(rng, base, 0.01)]),
            ("multi", [m[:30_000], _revcomp(m[30_000:60_000]), m[60_000:]]),
            ("far", [mutate(rng, base, 0.05, 0.002)]),
            ("unrelated", [random_genome(rng, 70_000)])]
    return refs, mutate(rng, base, 0.015)


@pytest.mark.parametrize("seed", [True, False])
def test_sketch_bytes_equal_jax(genomes, seed):
    """A multi-contig genome (one contig reverse-complemented), and the
    same genome with ``seed=False`` (an empty seed table)."""
    refs, _ = genomes
    contigs = refs[1][1]
    want = jax_storage.sketch_to_bytes(
        jax_sketch("multi", contigs, JaxParams(), seed=seed), JaxParams())
    host = sketch_genome_device("multi", contigs, SketchParams(), seed=seed,
                                device="cpu")
    got = storage.sketch_to_bytes(host, SketchParams())
    assert got == want
    back, params = storage.sketch_from_bytes(got)
    assert params == SketchParams()
    assert back.name == "multi" and back.lengths == host.lengths
    assert back.contig_names == host.contig_names
    n, m = int(host.device.n_seeds), int(host.device.n_markers)
    assert int(back.device.n_seeds) == n and int(back.device.n_markers) == m
    for f in FIELDS:
        a, b = getattr(back.device, f), getattr(host.device, f)
        if a.dim():
            rows = m if f.startswith("markers") else \
                b.shape[0] if f == "contig_lengths" else n
            a, b = a[:rows], b[:rows]
        assert torch.equal(a, b), f
    assert storage.sketch_to_bytes(back, params) == got


@pytest.mark.parametrize("fmt", FORMATS)
def test_store_files_byte_equal_jax(genomes, tmp_path, fmt):
    """markers.bin, index.db and the sketch files of a store written by
    each package."""
    refs, _ = genomes
    with pyskani_tpu.Database(tmp_path / "jax", format=fmt) as jdb:
        for name, contigs in refs:
            jdb.sketch(name, *contigs)
    with pyskani_tpu_torch.Database(tmp_path / "port", format=fmt,
                                    device="cpu") as tdb:
        for name, contigs in refs:
            tdb.sketch(name, *contigs)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    want = {"consolidated": ["index.db", "markers.bin", "sketches.db"],
            "separated": ["far.sketch", "markers.bin", "multi.sketch",
                          "near.sketch", "unrelated.sketch"]}[fmt]
    assert files == want
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def _assert_same_hits(got, want):
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want]
    for g, w in zip(got, want):
        for attr in ("identity", "query_fraction", "reference_fraction"):
            assert getattr(g, attr) == pytest.approx(getattr(w, attr),
                                                     abs=1e-6), attr


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_store_opens_in_the_other_package(genomes, tmp_path, writer, fmt):
    """Written by one package (``sketch`` into a folder, or ``save`` of a
    memory store), opened and loaded by both: equal hits."""
    refs, q = genomes
    if writer == "jax":
        db = pyskani_tpu.Database()
    else:
        db = pyskani_tpu_torch.Database(device="cpu")
    for name, contigs in refs:
        db.sketch(name, *contigs)
    db.save(tmp_path / "db", format=fmt)
    want = pyskani_tpu.Database.open(tmp_path / "db").query(
        "q", q, learned_ani=False)
    assert [h.reference_name for h in want] == ["near", "multi", "far"]
    for opener in (pyskani_tpu_torch.Database.open,
                   pyskani_tpu_torch.Database.load):
        port = opener(tmp_path / "db", device="cpu")
        assert port.path == tmp_path / "db" if opener.__name__ == "open" \
            else port.path is None
        _assert_same_hits(port.query("q", q, learned_ani=False), want)


def test_folder_separated(tmp_path):
    db = pyskani_tpu_torch.Database(tmp_path, format="separated",
                                    device="cpu")
    db.sketch("test1", b"ATGC" * 100)
    db.sketch("test2", b"TTGC" * 100)
    assert (tmp_path / "test1.sketch").exists()
    assert (tmp_path / "test2.sketch").exists()
    assert not (tmp_path / "markers.bin").exists()
    db.flush()
    assert (tmp_path / "markers.bin").exists()
    assert db.path == pathlib.Path(tmp_path)


def test_folder_consolidated(tmp_path):
    db = pyskani_tpu_torch.Database(tmp_path, format="consolidated",
                                    device="cpu")
    db.sketch("test1", b"ATGC" * 100)
    db.sketch("test2", b"TTGC" * 100)
    assert (tmp_path / "sketches.db").exists()
    assert not (tmp_path / "index.db").exists()
    assert not (tmp_path / "markers.bin").exists()
    db.flush()
    assert (tmp_path / "index.db").exists()
    assert (tmp_path / "markers.bin").exists()
    assert db.path == pathlib.Path(tmp_path)


def test_folder_is_created(tmp_path):
    db = pyskani_tpu_torch.Database(tmp_path / "a" / "b", device="cpu")
    assert db.path == tmp_path / "a" / "b" and db.path.is_dir()


def test_invalid_format(tmp_path):
    with pytest.raises(ValueError, match="invalid format"):
        pyskani_tpu_torch.Database(tmp_path, format="bogus", device="cpu")
    db = pyskani_tpu_torch.Database(device="cpu")
    with pytest.raises(ValueError, match="invalid format"):
        db.save(tmp_path / "s", format="bogus")


def test_existing_markers_rejected(tmp_path):
    with pyskani_tpu_torch.Database(tmp_path, device="cpu") as db:
        db.sketch("a", b"ATGC" * 100)
    with pytest.raises(FileExistsError):
        pyskani_tpu_torch.Database(tmp_path, device="cpu")
    mem = pyskani_tpu_torch.Database(device="cpu")
    mem.sketch("b", b"ATGC" * 100)
    with pytest.raises(FileExistsError):
        mem.save(tmp_path)
    mem.save(tmp_path, overwrite=True, format="separated")
    assert [m.name for m in pyskani_tpu_torch.Database.open(
        tmp_path, device="cpu")._markers] == ["b"]


def test_duplicate_name_consolidated(tmp_path):
    db = pyskani_tpu_torch.Database(tmp_path, format="consolidated",
                                    device="cpu")
    db.sketch("dup", b"ATGC" * 100)
    with pytest.raises(ValueError, match="duplicate"):
        db.sketch("dup", b"ATGC" * 100)


def test_context_manager_flushes(tmp_path):
    with pyskani_tpu_torch.Database(tmp_path, device="cpu") as db:
        db.sketch("test1", b"ATGC" * 100)
    assert (tmp_path / "markers.bin").exists()
    assert (tmp_path / "index.db").exists()


def test_missing_folder_and_sketch(tmp_path):
    with pytest.raises(OSError) as err:
        pyskani_tpu_torch.Database.open(tmp_path / "nope", device="cpu")
    assert err.value.errno == 2
    with pyskani_tpu_torch.Database(tmp_path, format="separated",
                                    device="cpu") as db:
        db.sketch("x", b"ATGC" * 200)
    os.remove(tmp_path / "x.sketch")
    opened = pyskani_tpu_torch.Database.open(tmp_path, device="cpu")
    with pytest.raises(OSError) as err:
        opened._storage.load("x")
    assert err.value.errno == 2


def test_missing_sketch_keyerror(tmp_path):
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("x", b"ATGC" * 200)
    with pytest.raises(KeyError):
        db._storage.load("nope")
    with pyskani_tpu_torch.Database(tmp_path, device="cpu") as disk:
        disk.sketch("x", b"ATGC" * 200)
    with pytest.raises(KeyError):
        pyskani_tpu_torch.Database.open(tmp_path,
                                        device="cpu")._storage.load("nope")


def _roundtrip(tmp_path, fmt, loader):
    rng = np.random.default_rng(42)
    g1 = random_genome(rng, 60_000)
    g2 = random_genome(rng, 50_000)
    with pyskani_tpu_torch.Database(tmp_path, format=fmt,
                                    device="cpu") as db:
        db.sketch("g1", g1)
        db.sketch("g2", g2)
        q = mutate(rng, g1, sub_rate=0.02)
        hits_before = db.query("q", q)
    db2 = loader(tmp_path, device="cpu")
    assert db2.compression == 125 and db2.marker_compression == 1000
    hits_after = db2.query("q", q)
    assert len(hits_after) == len(hits_before) == 1
    assert hits_after[0].reference_name == "g1"
    assert hits_after[0].identity == pytest.approx(hits_before[0].identity,
                                                   abs=1e-6)
    mem = pyskani_tpu_torch.Database(device="cpu")
    mem.sketch("g1", g1)
    mem.sketch("g2", g2)
    _assert_same_hits(hits_after, mem.query("q", q))


@pytest.mark.parametrize("fmt", FORMATS)
def test_open_roundtrip(tmp_path, fmt):
    _roundtrip(tmp_path, fmt, pyskani_tpu_torch.Database.open)


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_roundtrip(tmp_path, fmt):
    _roundtrip(tmp_path, fmt, pyskani_tpu_torch.Database.load)


def test_load_puts_sketches_on_the_database_device(tmp_path):
    with pyskani_tpu_torch.Database(tmp_path, device="cpu") as db:
        db.sketch("x", b"ATGC" * 200)
    loaded = pyskani_tpu_torch.Database.load(tmp_path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded._storage.load("x").device.device == torch.device("cpu")


def test_open_default_device_is_cuda(tmp_path):
    """A store opened with the default device runs on the card, or
    raises: it never goes on quietly on the CPU."""
    with pyskani_tpu_torch.Database(tmp_path, device="cpu") as db:
        db.sketch("x", b"ATGC" * 200)
    for opener in (pyskani_tpu_torch.Database.open,
                   pyskani_tpu_torch.Database.load):
        if torch.cuda.is_available():
            assert opener(tmp_path).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                opener(tmp_path)
