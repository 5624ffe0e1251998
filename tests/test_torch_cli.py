"""Port CLI (``sketch``, ``dist``, ``search``, ``triangle``) vs the JAX
package's CLI.

The same FASTA files go through ``pyskani_tpu.cli`` and
``pyskani_tpu_torch.cli --device cpu``: the same rows, and every number
within 0.01 of the JAX package's printed value (both print 2 decimals, so
a last-ulp difference may flip the rounding), at the default k and at
``-k 16``.  ``--mesh 2x2 --device cpu`` runs 4 spawned gloo ranks and
prints the JAX CLI's ``--mesh 2x2`` rows; ``--ci`` with ``--mesh`` exits
with code 2, as in the JAX CLI; without CUDA the default device refuses
to run.
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
import pyskani_tpu.oracle.chain as jax_chain_config
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
    if len(g_lines[0].split("\t")) == 7:
        # the --ci bounds agree within 1e-6 (tests/test_torch_ci.py), so
        # their printed percentages agree exactly on these inputs
        for g_line, w_line in zip(g_lines[1:], w_lines[1:]):
            assert g_line.split("\t")[5:] == w_line.split("\t")[5:]


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


# what the JAX package lacks too: --ci with --mesh exits 2 in both CLIs
NOT_PORTED = {
    "triangle_mesh": ["triangle", "base.fa", "mut3.fa", "--mesh", "2x1",
                      "--ci"],
    "search_mesh": ["search", "-d", "DB", "base.fa", "--mesh", "2x1",
                    "--ci"],
}


def test_dist_k16_matches_jax_cli(fasta, capsys):
    argv = ["dist", "-q", fasta["mut1.fa.gz"], fasta["mut3.fa"], "-r",
            fasta["base.fa"], fasta["draft.fa"], fasta["other.fa"],
            "--learned-ani", "no", "-k", "16"]
    rc_w, want, _ = _run(jax_cli.main, argv, capsys)
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    assert len(got.strip().splitlines()) == 1 + 4


def test_triangle_k16_matches_jax_cli(fasta, capsys, monkeypatch):
    """``triangle -k 16`` chains with k = 16, as ``Database.query`` does.
    The JAX CLI's triangle builds ``ChainConfig()`` (k = 15) whatever
    ``-k`` says, so it runs here with its ChainConfig bound to k = 16
    (ANI exponent 1/16, intervals extended by 15)."""
    genomes = [fasta[n] for n in ("base.fa", "mut1.fa.gz", "mut3.fa",
                                  "draft.fa", "other.fa")]
    real = jax_chain_config.ChainConfig
    monkeypatch.setattr(
        jax_chain_config, "ChainConfig",
        lambda **kw: dataclasses.replace(real(**kw), k=16, extend_right=15))
    rc_w, want, _ = _run(jax_cli.main, ["triangle", *genomes, "-k", "16"],
                         capsys)
    rc, got, _ = _run(cli.main, ["triangle", *genomes, "-k", "16",
                                 "--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    assert len(got.strip().splitlines()) == 1 + 6


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_not_ported_exit_2(fasta, capsys, case):
    argv = [fasta.get(a, a) for a in NOT_PORTED[case]]
    rc, out, err = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 2
    assert "--ci is not supported with --mesh" in err
    assert out == ""
    if case == "triangle_mesh":
        assert _run(jax_cli.main, argv, capsys)[0] == 2


@pytest.fixture
def jax_mesh_of_4(monkeypatch):
    """The JAX CLI's ``--mesh DBxBATCH`` builds its mesh over every
    device; here it takes the first DB*BATCH of the 8 virtual ones."""
    import jax
    from pyskani_tpu.parallel import mesh as jax_mesh
    real = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda db, batch: real(
        db, batch, devices=jax.devices()[:db * batch]))


def test_triangle_mesh_matches_jax_cli(fasta, capsys, jax_mesh_of_4):
    genomes = [fasta[n] for n in ("base.fa", "mut1.fa.gz", "mut3.fa",
                                  "draft.fa", "other.fa")]
    argv = ["triangle", *genomes, "--mesh", "2x2"]
    rc_w, want, _ = _run(jax_cli.main, argv, capsys)
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    assert len(got.strip().splitlines()) == 1 + 6


def test_mesh_under_torchrun_environment(fasta, capsys, monkeypatch,
                                         jax_mesh_of_4):
    """With the variables ``torchrun`` sets, this process is one rank: it
    joins the world over TCP, writes rank 0's rows and leaves the group;
    a mesh of another size than the world exits 2."""
    import socket

    import torch.distributed as dist
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    genomes = [fasta[n] for n in ("base.fa", "mut1.fa.gz", "mut3.fa")]
    rc_w, want, _ = _run(jax_cli.main, ["triangle", *genomes, "--mesh",
                                        "1x1"], capsys)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    rc, got, _ = _run(cli.main, ["triangle", *genomes, "--mesh", "1x1",
                                 "--device", "cpu"], capsys)
    assert rc == rc_w == 0 and not dist.is_initialized()
    _assert_same_output(got, want)
    rc, out, err = _run(cli.main, ["triangle", *genomes, "--mesh", "2x1",
                                   "--device", "cpu"], capsys)
    assert rc == 2 and out == "" and not dist.is_initialized()
    assert "needs 2 ranks, torchrun started 1" in err


def test_mesh_spec_and_cards(fasta, capsys, monkeypatch):
    """A malformed ``--mesh`` exits 2; so does a mesh with more ranks
    than cards on ``cuda``."""
    argv = ["triangle", fasta["base.fa"], fasta["mut3.fa"], "--mesh"]
    for bad in ("2", "2x", "0x1", "axb"):
        rc, out, err = _run(cli.main, argv + [bad, "--device", "cpu"],
                            capsys)
        assert rc == 2 and out == "" and "bad --mesh" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _run(cli.main, argv + ["2x1"], capsys)
    assert rc == 2 and out == ""
    assert "needs 2 CUDA devices, found 1" in err


SEARCH = {
    "open": [],
    "preload": ["--preload"],
    "ci": ["--ci", "--learned-ani", "no"],
    "preload_ci": ["--preload", "--ci"],
}


@pytest.fixture(scope="module")
def stores(fasta, tmp_path_factory):
    """The family's reference store sketched by each CLI, in each format:
    {(cli, format): folder}."""
    refs = [fasta[n] for n in ("base.fa", "draft.fa", "other.fa")]
    out = {}
    for label, main, extra in (("jax", jax_cli.main, []),
                               ("port", cli.main, ["--device", "cpu"])):
        for fmt in ("consolidated", "separated"):
            d = tmp_path_factory.mktemp(f"{label}_{fmt}")
            assert main(["sketch", *refs, "-o", str(d), "--format", fmt,
                         *extra]) == 0
            out[(label, fmt)] = d
    return out


def test_sketch_writes_the_chosen_format(stores):
    """``--format`` reaches the store (the JAX CLI parses it and drops it,
    so its stores are consolidated either way)."""
    names = {k: sorted(os.listdir(v)) for k, v in stores.items()}
    assert names[("port", "consolidated")] == \
        ["index.db", "markers.bin", "sketches.db"]
    assert names[("port", "separated")] == \
        ["base.fa.sketch", "draft.fa.sketch", "markers.bin",
         "other.fa.sketch"]
    for fmt in ("consolidated", "separated"):
        assert names[("jax", fmt)] == names[("port", "consolidated")]
    for f in names[("jax", "consolidated")]:
        assert (stores[("port", "consolidated")] / f).read_bytes() == \
            (stores[("jax", "consolidated")] / f).read_bytes(), f


@pytest.mark.parametrize("fmt", ["consolidated", "separated"])
@pytest.mark.parametrize("variant", list(SEARCH))
def test_sketch_search_matches_jax_cli(fasta, stores, capsys, variant, fmt):
    queries = [fasta["mut1.fa.gz"], fasta["mut3.fa"]]
    rc_w, want, _ = _run(jax_cli.main, ["search", "-d",
                                        str(stores[("jax", fmt)]), *queries,
                                        *SEARCH[variant]], capsys)
    rc, got, _ = _run(cli.main, ["search", "-d", str(stores[("port", fmt)]),
                                 *queries, *SEARCH[variant], "--device",
                                 "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    rows = got.strip().splitlines()
    assert len(rows) == 1 + 4
    assert len(rows[1].split("\t")) == (7 if "--ci" in SEARCH[variant]
                                        else 5)


@pytest.mark.parametrize("preload", [False, True])
def test_search_mesh_matches_jax_cli(fasta, stores, capsys, jax_mesh_of_4,
                                     preload):
    queries = [fasta["mut1.fa.gz"], fasta["mut3.fa"]]
    flags = ["--mesh", "2x2", "--learned-ani", "no"] + \
        (["--preload"] if preload else [])
    rc_w, want, _ = _run(jax_cli.main, [
        "search", "-d", str(stores[("jax", "consolidated")]), *queries,
        *flags], capsys)
    rc, got, _ = _run(cli.main, [
        "search", "-d", str(stores[("port", "consolidated")]), *queries,
        *flags, "--device", "cpu"], capsys)
    assert rc == rc_w == 0
    _assert_same_output(got, want)
    assert len(got.strip().splitlines()) == 1 + 4


def test_search_without_queries_exits_2(stores, capsys):
    rc, out, err = _run(cli.main, ["search", "-d",
                                   str(stores[("port", "separated")]),
                                   "--device", "cpu"], capsys)
    assert rc == 2 and out == "" and "no query genomes" in err


def test_default_device_refuses_without_cuda(fasta, capsys, monkeypatch,
                                             tmp_path):
    """Without CUDA and without ``--device cpu`` the CLI exits non-zero
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["triangle", fasta["base.fa"], fasta["mut3.fa"]],
                 ["dist", "-q", fasta["base.fa"], "-r", fasta["mut3.fa"]],
                 ["sketch", fasta["base.fa"], "-o", str(tmp_path / "db")]):
        rc, out, err = _run(cli.main, argv, capsys)
        assert rc != 0 and out == ""
        assert "CUDA is not available" in err and "--device cpu" in err
