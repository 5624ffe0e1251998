"""The port's native FASTA reader (``io/native.py``, ``csrc/fasta_reader.cpp``).

``tests/test_native_fasta.py``'s three cases on the port's binding, built
here with g++ into the port's build directory; gzipped files; the
fallback to the Python parser where the reader cannot be built; and the
CLI's ``dist`` rows equal with the reader and without it.
"""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyskani_tpu_torch import cli
from pyskani_tpu_torch.io import native
from pyskani_tpu_torch.io.fasta import parse, read_genome
from pyskani_tpu_torch.ops._build import build_dir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler to build the reader")


@pytest.fixture()
def multi_fasta(tmp_path):
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    contigs = [rng.choice(acgt, size=n).tobytes() for n in (5000, 130, 7001)]
    # mixed-case, wrapped lines, comments and blank lines
    lines = [b"; leading comment"]
    for i, seq in enumerate(contigs):
        lines.append(f">contig{i} description {i}".encode())
        body = seq.lower() if i == 1 else seq
        lines += [body[j:j + 61] for j in range(0, len(body), 61)]
        lines.append(b"")
    path = tmp_path / "multi.fa"
    path.write_bytes(b"\n".join(lines) + b"\n")
    return path, contigs


def test_native_matches_python(multi_fasta):
    path, contigs = multi_fasta
    out = native.read_genome_native(path)
    assert out is not None
    seq, starts, names = out

    records = list(parse(str(path)))
    assert names == [r.id for r in records]
    assert len(starts) == len(contigs) + 1
    for i, r in enumerate(records):
        got = seq[starts[i]:starts[i + 1]].tobytes()
        assert got.upper() == r.seq.upper() == contigs[i]


def test_native_min_contig_filter(multi_fasta):
    path, contigs = multi_fasta
    out = native.read_genome_native(path, min_contig_len=1000)
    assert out is not None
    seq, starts, names = out
    keep = [c for c in contigs if len(c) >= 1000]
    assert len(names) == len(keep)
    for i, c in enumerate(keep):
        assert seq[starts[i]:starts[i + 1]].tobytes().upper() == c


def test_native_missing_file(tmp_path):
    assert native.read_genome_native(tmp_path / "nope.fa") is None


def test_built_in_the_port_build_dir(multi_fasta):
    """The library is the port's own build, hash-keyed in its build
    directory; a fresh interpreter that reads through it (the CLI's
    path) maps that library and never the JAX package's committed one."""
    assert native.available()
    lib = native._target()
    assert os.path.dirname(lib) == build_dir() and os.path.exists(lib)
    assert os.path.basename(lib).startswith("fasta_reader-")
    path, contigs = multi_fasta
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "from pyskani_tpu_torch.cli import _genome_records\n"
            f"recs = list(_genome_records([{str(path)!r}]))\n"
            "print(len(recs[0][1]))\n"
            "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    n, maps = out.stdout.split("\n", 1)
    assert int(n) == len(contigs)
    assert lib in maps
    assert os.path.join(REPO, "native", "libfasta_reader.so") not in maps


def test_gzip_and_fallback_give_the_same_contigs(multi_fasta, tmp_path,
                                                 monkeypatch):
    path, contigs = multi_fasta
    gz = tmp_path / "multi.fa.gz"
    with gzip.open(gz, "wb") as f:
        f.write(path.read_bytes())
    want = read_genome(path)
    assert [c.upper() for c in want] == contigs
    for p in (path, gz):
        assert native.read_contigs(p) == want
    monkeypatch.setattr(native, "_lib", False)    # as without a compiler
    assert native.read_genome_native(path) is None
    for p in (path, gz):
        assert native.read_contigs(p) == want


def test_cli_dist_rows_equal_with_and_without_reader(tmp_path, capsys,
                                                     monkeypatch):
    rng = np.random.default_rng(22)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, size=50_000)
    paths = []
    for name, sub in (("r", 0.0), ("q", 0.02)):
        g = base.copy()
        idx = rng.integers(0, len(g), int(len(g) * sub))
        g[idx] = rng.choice(acgt, size=len(idx))
        text = g.tobytes()
        body = b"\n".join(text[j:j + 70] for j in range(0, len(text), 70))
        paths.append(str(tmp_path / f"{name}.fa.gz"))
        with gzip.open(paths[-1], "wb") as f:
            f.write(b">" + name.encode() + b"_0\n" + body[:30_000] +
                    b"\n>" + name.encode() + b"_1\n" + body[30_000:] + b"\n")
    argv = ["dist", "-q", paths[1], "-r", paths[0], "--learned-ani", "no",
            "--device", "cpu"]
    assert native.available()
    assert cli.main(argv) == 0
    with_reader = capsys.readouterr().out
    monkeypatch.setattr(native, "_lib", False)
    assert cli.main(argv) == 0
    without = capsys.readouterr().out
    assert with_reader == without
    assert len(with_reader.strip().splitlines()) == 2
