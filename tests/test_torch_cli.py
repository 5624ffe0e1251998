"""Port CLI (``dist``, ``triangle``) vs the JAX package's CLI.

The same FASTA files go through ``pyskani_tpu.cli`` and
``pyskani_tpu_torch.cli --device cpu``: the same rows, and every number
within 0.01 of the JAX package's printed value (both print 2 decimals, so
a last-ulp difference may flip the rounding).  Commands and flags that
are not ported yet exit with code 2; without CUDA the default device
refuses to run.
"""

import gzip

import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu import cli as jax_cli
from pyskani_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Four genomes of one 60 kb family (one gzipped, one a 3-contig
    draft), one unrelated genome, and list files of them."""
    d = tmp_path_factory.mktemp("fasta")
    rng = np.random.default_rng(21)
    base = random_genome(rng, 60_000)
    draft = mutate(rng, base, 0.02)
    records = {
        "base.fa": [base],
        "mut1.fa.gz": [mutate(rng, base, 0.01)],
        "mut3.fa": [mutate(rng, base, 0.03)],
        "draft.fa": [draft[:20_000], draft[20_000:45_000], draft[45_000:]],
        "other.fa": [random_genome(rng, 50_000)],
    }
    paths = {}
    for name, contigs in records.items():
        text = "".join(f">{name}_{i} test\n{c.decode()}\n"
                       for i, c in enumerate(contigs))
        p = d / name
        if name.endswith(".gz"):
            with gzip.open(p, "wt") as f:
                f.write(text)
        else:
            p.write_text(text)
        paths[name] = str(p)
    names = list(records)
    (d / "all.txt").write_text("\n".join(paths[n] for n in names) + "\n")
    (d / "refs.txt").write_text(f"# refs\n{paths['base.fa']}\n"
                                f"{paths['draft.fa']}\n")
    paths["all.txt"] = str(d / "all.txt")
    paths["refs.txt"] = str(d / "refs.txt")
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _assert_same_output(got: str, want: str):
    g_lines, w_lines = got.strip().splitlines(), want.strip().splitlines()
    assert len(g_lines) == len(w_lines) >= 2
    for g_line, w_line in zip(g_lines, w_lines):
        g, w = g_line.split("\t"), w_line.split("\t")
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert abs(fa - fb) <= 0.01 + 1e-9, (g_line, w_line)


TRIANGLE = {
    "tsv": [],
    "full_matrix": ["--full-matrix"],
    "full_matrix_distance": ["--full-matrix", "--distance"],
    "distance": ["--distance"],
    "median": ["--median", "--min-af", "50"],
    "robust": ["--robust"],
}


@pytest.mark.parametrize("variant", list(TRIANGLE))
def test_triangle_matches_jax_cli(fasta, capsys, variant):
    genomes = [fasta[n] for n in ("base.fa", "mut1.fa.gz", "mut3.fa",
                                  "draft.fa", "other.fa")]
    flags = TRIANGLE[variant]
    rc_w, want, _ = _run(jax_cli.main, ["triangle", *genomes, *flags],
                         capsys)
    rc, got, _ = _run(cli.main, ["triangle", *genomes, *flags,
                                 "--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    if variant == "tsv":
        assert len(got.strip().splitlines()) == 1 + 6   # the family's pairs


def test_triangle_list_file_and_output_file(fasta, capsys, tmp_path):
    out_w, out_t = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_cli.main(["triangle", "-l", fasta["all.txt"], "-o",
                         str(out_w)]) == 0
    assert cli.main(["triangle", "-l", fasta["all.txt"], "-o", str(out_t),
                     "--device", "cpu"]) == 0
    _assert_same_output(out_t.read_text(), out_w.read_text())
    assert capsys.readouterr().out == ""


DIST = {
    "raw": ["--learned-ani", "no"],
    "learned": [],
    "robust": ["--robust", "--learned-ani", "no"],
    "ref_list": ["--learned-ani", "no", "--rl", "refs.txt"],
}


@pytest.mark.parametrize("variant", list(DIST))
def test_dist_matches_jax_cli(fasta, capsys, variant):
    flags = [fasta.get(a, a) for a in DIST[variant]]
    refs = [] if variant == "ref_list" else \
        ["-r", fasta["base.fa"], fasta["draft.fa"], fasta["other.fa"]]
    argv = ["dist", "-q", fasta["mut1.fa.gz"], fasta["mut3.fa"], *refs,
            *flags]
    rc_w, want, _ = _run(jax_cli.main, argv, capsys)
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    assert len(got.strip().splitlines()) == 1 + 4


NOT_PORTED = {
    "sketch": (["sketch", "-o", "DB", "base.fa"], "A.10"),
    "search": (["search", "-d", "DB", "base.fa"], "A.10"),
    "dist_ci": (["dist", "-q", "base.fa", "-r", "mut3.fa", "--ci"], "A.9"),
    "triangle_ci": (["triangle", "base.fa", "mut3.fa", "--ci"], "A.9"),
    "triangle_mesh": (["triangle", "base.fa", "mut3.fa", "--mesh", "2x1"],
                      "A.12"),
}


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_not_ported_exit_2(fasta, capsys, case):
    argv, item = NOT_PORTED[case]
    rc, out, err = _run(cli.main, [fasta.get(a, a) for a in argv] +
                        ["--device", "cpu"] * (argv[0] in ("dist",
                                                            "triangle")),
                        capsys)
    assert rc == 2
    assert "not ported" in err and f"ROADMAP {item}" in err
    assert out == ""


def test_default_device_refuses_without_cuda(fasta, capsys, monkeypatch):
    """Without CUDA and without ``--device cpu`` the CLI exits non-zero
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["triangle", fasta["base.fa"], fasta["mut3.fa"]],
                 ["dist", "-q", fasta["base.fa"], "-r", fasta["mut3.fa"]]):
        rc, out, err = _run(cli.main, argv, capsys)
        assert rc != 0 and out == ""
        assert "CUDA is not available" in err and "--device cpu" in err
