"""Command-line interface of the PyTorch engine: skani's four modes.

  skani-tpu-torch sketch   -o DIR genome1.fa [genome2.fa ...]
  skani-tpu-torch dist     -q query.fa [...] -r ref.fa [...]
  skani-tpu-torch search   -d DIR query.fa [...]
  skani-tpu-torch triangle genome1.fa genome2.fa [...]

The arguments, the TSV and the ``--full-matrix`` / ``--distance`` forms
are those of the JAX package's ``skani-tpu``.  Output is skani-style TSV:
  Ref_file  Query_file  ANI  Align_fraction_ref  Align_fraction_query
with ``--ci`` adding ANI_5_percentile and ANI_95_percentile (the
bootstrap interval).  ``sketch --format`` sets the store's format.

Every command runs on ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions) and takes ``-k`` (4-32, default 15).  FASTA files
are read by the port's native reader (``io/native.py``, built with g++
at first use), or by the Python parser where it cannot be built.  With
``PYSKANI_TORCH_PROFILE=1`` each command ends by printing
``stats: <json>`` (``utils/profiling.py``) on stderr.

``search --mesh DBxBATCH`` and ``triangle --mesh DBxBATCH`` run on
DB*BATCH ranks (``parallel/``): under ``torchrun`` the ranks come from its
environment; otherwise the command spawns them, one card each on
``cuda`` (it exits 2 when there are fewer cards) or gloo ranks with
``--device cpu``.  Rank 0's rows are written.  ``--ci`` with ``--mesh``
exits 2, as in the JAX package.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import List


def _add_sketch_params(p):
    p.add_argument("-c", "--compression", type=int, default=125,
                   help="compression factor (sketch density)")
    p.add_argument("-m", "--marker-compression", type=int, default=1000,
                   help="marker k-mer compression factor")
    p.add_argument("-k", type=int, default=15, help="k-mer size")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions)")


def _add_query_params(p):
    p.add_argument("--median", action="store_true",
                   help="estimate median instead of mean identity")
    p.add_argument("--robust", action="store_true",
                   help="10%%/90%% trimmed-mean identity")
    p.add_argument("-s", "--screen", type=float, default=None,
                   help="marker screening ANI cutoff (fraction or percent)")
    p.add_argument("--faster-small", action="store_true",
                   help="screen genomes with <20 markers aggressively")
    p.add_argument("--learned-ani", choices=["auto", "yes", "no"],
                   default="auto")
    p.add_argument("--min-af", type=float, default=15.0,
                   help="minimum aligned fraction (percent) to report")
    p.add_argument("--ci", action="store_true",
                   help="report [5%%, 95%%] percentile-bootstrap ANI "
                        "confidence intervals (extra output columns)")
    p.add_argument("-o", "--output-file", default=None,
                   help="write results to this file instead of stdout")
    p.add_argument("-n", "--max-results", type=int, default=1_000_000_000,
                   help="keep at most this many hits per query "
                        "(best ANI first)")
    _add_device(p)


def _learned(val):
    return {"auto": None, "yes": True, "no": False}[val]


def _screen_val(s):
    if s is None:
        return None
    return s / 100.0 if s > 1.0 else s


def _header(out, ci=False):
    cols = "Ref_file\tQuery_file\tANI\tAlign_fraction_ref\t" \
           "Align_fraction_query"
    if ci:
        cols += "\tANI_5_percentile\tANI_95_percentile"
    out.write(cols + "\n")


def _emit(out, ref_name, query_name, ani, af_r, af_q, ci=None):
    row = (f"{ref_name}\t{query_name}\t{100*ani:.2f}\t"
           f"{100*af_r:.2f}\t{100*af_q:.2f}")
    if ci is not None:
        row += f"\t{100*ci[0]:.2f}\t{100*ci[1]:.2f}"
    out.write(row + "\n")


class _out_stream:
    """Context manager: ``-o FILE`` or stdout (skani's out_file_name)."""

    def __init__(self, path):
        self._path = path
        self._fh = None

    def __enter__(self):
        if self._path is None:
            return sys.stdout
        self._fh = open(self._path, "w")
        return self._fh

    def __exit__(self, *exc):
        if self._fh is not None:
            self._fh.close()
        return False


def _expand_lists(paths: List[str], list_files: List[str] | None) -> List[str]:
    """Positional paths plus newline-separated paths from -l list files
    (skani's file-of-filenames input convention)."""
    out = list(paths)
    for lf in list_files or ():
        with open(lf) as f:
            out.extend(line.strip() for line in f
                       if line.strip() and not line.startswith("#"))
    return out


def _genome_records(paths: List[str]):
    """Yield (name, contigs) per FASTA file (whole file = one genome),
    read by the native reader where it is built, else the Python parser."""
    from .io.native import read_contigs
    for path in paths:
        yield os.path.basename(path), read_contigs(path)


def cmd_sketch(args) -> int:
    from .database import Database
    genomes = _expand_lists(args.genomes, args.list_files)
    if not genomes:
        print("error: no input genomes (positional or -l)", file=sys.stderr)
        return 2
    with Database(args.output, compression=args.compression,
                  marker_compression=args.marker_compression, k=args.k,
                  format=args.format, device=args.device) as db:
        db.sketch_many(_genome_records(genomes))
        print(f"sketched {len(genomes)} genomes", file=sys.stderr)
    return 0


def _emit_hits(out, hits, args) -> None:
    """One query's hit rows: those with an aligned fraction of at least
    ``--min-af``, best ANI first, capped at ``--max-results``."""
    hits = [h for h in hits
            if max(h.query_fraction,
                   h.reference_fraction) * 100 >= args.min_af]
    hits.sort(key=lambda h: -h.identity)
    for h in hits[:args.max_results]:
        ci = (h.ci_low, h.ci_high) if args.ci else None
        _emit(out, h.reference_name, h.query_name, h.identity,
              h.reference_fraction, h.query_fraction, ci)


def _run_queries(db, args, out) -> None:
    """Query each input genome and emit filtered, capped hit rows."""
    _header(out, ci=args.ci)
    for qname, qcontigs in _genome_records(args.queries):
        _emit_hits(out, db.query(
            qname, *qcontigs, median=args.median, robust=args.robust,
            cutoff=_screen_val(args.screen), faster_small=args.faster_small,
            learned_ani=_learned(args.learned_ani), est_ci=args.ci), args)


def cmd_dist(args) -> int:
    from .database import Database
    args.queries = _expand_lists(args.queries, args.query_lists)
    refs = _expand_lists(args.refs, args.ref_lists)
    if not args.queries or not refs:
        print("error: need at least one query (-q/--ql) and one "
              "reference (-r/--rl)", file=sys.stderr)
        return 2
    db = Database(compression=args.compression,
                  marker_compression=args.marker_compression, k=args.k,
                  device=args.device)
    db.sketch_many(_genome_records(refs))
    with _out_stream(args.output_file) as out:
        _run_queries(db, args, out)
    return 0


def cmd_search(args) -> int:
    from .database import Database
    args.queries = _expand_lists(args.queries, args.query_lists)
    if not args.queries:
        print("error: no query genomes (positional or --ql)",
              file=sys.stderr)
        return 2
    if args.mesh:
        return _run_mesh(args, _search_rank)
    opener = Database.load if args.preload else Database.open
    db = opener(args.database, device=args.device)
    with _out_stream(args.output_file) as out:
        _run_queries(db, args, out)
    return 0


def _search_rank(args, shape) -> str:
    """One rank of ``search --mesh``: the sharded search of every query;
    returns the TSV rows (every rank computes the same)."""
    from .database import Database
    from .parallel.mesh import make_mesh
    from .parallel.search import ShardedDatabaseSearch

    mesh = make_mesh(*shape, device=args.device)
    opener = Database.load if args.preload else Database.open
    db = opener(args.database, device=mesh.device)
    searcher = ShardedDatabaseSearch(
        db, mesh, cutoff=_screen_val(args.screen),
        learned_ani=_learned(args.learned_ani), median=args.median,
        robust=args.robust, faster_small=args.faster_small)
    all_hits = searcher.query_many(list(_genome_records(args.queries)))
    out = io.StringIO()
    _header(out)
    for hits in all_hits:
        _emit_hits(out, hits, args)
    return out.getvalue()


def _run_mesh(args, rank_fn) -> int:
    """``--mesh DBxBATCH``: ``rank_fn(args, (db, batch))`` on every rank
    of a DB*BATCH world, rank 0's rows written.  Under ``torchrun`` this
    process is one rank; otherwise the ranks are spawned (one process
    group of its own), or for a 1 x 1 mesh run here."""
    if args.ci:
        print("error: --ci is not supported with --mesh", file=sys.stderr)
        return 2
    try:
        shape = tuple(int(t) for t in args.mesh.lower().split("x"))
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError
    except ValueError:
        print(f"error: bad --mesh {args.mesh!r} (expected DBxBATCH)",
              file=sys.stderr)
        return 2
    world = shape[0] * shape[1]
    import torch
    import torch.distributed as dist

    from .parallel.dist import initialize_multihost, launch
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        initialize_multihost(device=args.device)
        try:
            if dist.get_world_size() != world:
                print(f"error: --mesh {args.mesh} needs {world} ranks, "
                      f"torchrun started {dist.get_world_size()}",
                      file=sys.stderr)
                return 2
            text = rank_fn(args, shape)
            first = dist.get_rank() == 0
        finally:
            dist.destroy_process_group()
    elif world == 1:
        text, first = rank_fn(args, shape), True
    else:
        if args.device == "cuda" and torch.cuda.device_count() < world:
            print(f"error: --mesh {args.mesh} needs {world} CUDA devices, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        text, first = launch(rank_fn, world, (args, shape),
                             device=args.device)[0], True
    if first:
        with _out_stream(args.output_file) as fh:
            fh.write(text)
    return 0


def _triangle_rank(args, shape) -> str:
    """One rank of ``triangle --mesh``: every genome sketched on this
    rank, the tiles spread over the mesh (``sharded_triangle``); returns
    the rows."""
    from .engine.batch import default_budgets, stack_sketches
    from .parallel.dist import sharded_triangle
    from .parallel.mesh import make_mesh

    mesh = make_mesh(*shape, device=args.device)
    sketches, cfg = _triangle_sketches(args, mesh.device)
    batch = stack_sketches(sketches)
    ri, qi, out = sharded_triangle(batch, mesh, cfg=cfg,
                                   budgets=default_budgets(sketches, batch,
                                                           cfg))
    fh = io.StringIO()
    _write_triangle(fh, args, [s.name for s in sketches], ri, qi, out)
    return fh.getvalue()


def _triangle_sketches(args, device):
    import dataclasses

    from .database import _chain_cfg_for
    from .ops.sketch import sketch_genomes_device
    from .params import SketchParams

    params = SketchParams(c=args.compression,
                          marker_c=args.marker_compression, k=args.k)
    sketches = sketch_genomes_device(list(_genome_records(args.genomes)),
                                     params, device=device)
    # the chain takes the sketch's k (ANI exponent 1/k, intervals extended
    # by k-1), as Database.query does; the JAX CLI's triangle keeps k=15
    return sketches, dataclasses.replace(_chain_cfg_for(params),
                                         est_ci=args.ci)


def cmd_triangle(args) -> int:
    from .engine.batch import triangle

    args.genomes = _expand_lists(args.genomes, args.list_files)
    if len(args.genomes) < 2:
        print("error: triangle needs at least two genomes", file=sys.stderr)
        return 2
    if args.mesh:
        return _run_mesh(args, _triangle_rank)
    sketches, cfg = _triangle_sketches(args, args.device)
    ri, qi, out = triangle(sketches, cfg=cfg)
    with _out_stream(args.output_file) as fh:
        _write_triangle(fh, args, [s.name for s in sketches], ri, qi, out)
    return 0


def _write_triangle(fh, args, names, ri, qi, out) -> None:
    key = "ani_median" if args.median else \
        "ani_robust" if args.robust else "ani_mean"
    if args.full_matrix:
        # PHYLIP-style lower-triangular matrix (skani triangle's
        # default output; the sparse TSV is this CLI's default)
        vals = {}
        for i in range(len(ri)):
            v = float(out[key][i])
            v = 100.0 - 100.0 * v if args.distance else 100.0 * v
            vals[(max(ri[i], qi[i]), min(ri[i], qi[i]))] = v
        diag = 0.0 if args.distance else 100.0
        fh.write(f"{len(names)}\n")
        for i, name in enumerate(names):
            row = [name]
            row += [f"{vals.get((i, j), 0.0):.2f}" for j in range(i)]
            row.append(f"{diag:.2f}")
            fh.write("\t".join(row) + "\n")
        return
    _header(fh, ci=args.ci)
    for i in range(len(ri)):
        ani = float(out[key][i])
        af_q = float(out["af_query"][i])
        af_r = float(out["af_ref"][i])
        if ani <= 0.1 or max(af_q, af_r) * 100 < args.min_af:
            continue
        if args.distance:
            ani = 1.0 - ani
        ci = (float(out["ani_ci_low"][i]),
              float(out["ani_ci_high"][i])) if args.ci else None
        _emit(fh, names[ri[i]], names[qi[i]], ani, af_r, af_q, ci)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="skani-tpu-torch",
        description="ANI computation (skani method) on the PyTorch engine")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("sketch", help="sketch genomes into a database")
    p.add_argument("genomes", nargs="*")
    p.add_argument("-l", "--list", dest="list_files", action="append",
                   help="file listing genome paths, one per line")
    p.add_argument("-o", "--output", required=True, help="database folder")
    p.add_argument("--format", choices=["consolidated", "separated"],
                   default=None)
    _add_sketch_params(p)
    _add_device(p)
    p.set_defaults(func=cmd_sketch)

    p = sub.add_parser("search", help="search a pre-sketched database")
    p.add_argument("queries", nargs="*")
    p.add_argument("--ql", dest="query_lists", action="append",
                   help="file listing query paths, one per line")
    p.add_argument("-d", "--database", required=True)
    p.add_argument("--preload", action="store_true",
                   help="load all sketches onto the device up front")
    p.add_argument("--mesh", default=None, metavar="DBxBATCH",
                   help="shard the store over DB ranks and the queries "
                        "over BATCH ranks (parallel/)")
    _add_query_params(p)
    p.set_defaults(func=cmd_search)

    p = sub.add_parser("dist", help="ANI between query and reference genomes")
    p.add_argument("-q", "--queries", nargs="*", default=[])
    p.add_argument("-r", "--refs", nargs="*", default=[])
    p.add_argument("--ql", dest="query_lists", action="append",
                   help="file listing query paths, one per line")
    p.add_argument("--rl", dest="ref_lists", action="append",
                   help="file listing reference paths, one per line")
    _add_sketch_params(p)
    _add_query_params(p)
    p.set_defaults(func=cmd_dist)

    p = sub.add_parser("triangle", help="all-vs-all ANI (lower triangle)")
    p.add_argument("genomes", nargs="*")
    p.add_argument("-l", "--list", dest="list_files", action="append",
                   help="file listing genome paths, one per line")
    p.add_argument("--full-matrix", action="store_true",
                   help="PHYLIP-style lower-triangular matrix output "
                        "(skani triangle's default form)")
    p.add_argument("--distance", action="store_true",
                   help="output distance (100 - ANI) instead of ANI")
    p.add_argument("-E", "--sparse", action="store_true",
                   help="sparse TSV edge list (this CLI's default; flag "
                        "kept for skani compatibility)")
    p.add_argument("--mesh", default=None, metavar="DBxBATCH",
                   help="spread the triangle's tiles over DB*BATCH ranks "
                        "(parallel/)")
    _add_sketch_params(p)
    _add_query_params(p)
    p.set_defaults(func=cmd_triangle)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"error: --device {args.device}: CUDA is not available; pass "
              f"--device cpu to run on the CPU", file=sys.stderr)
        return 1
    try:
        rc = args.func(args)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from .utils import profiling
    if profiling.enabled():
        import json
        snap = profiling.stats().snapshot()
        print("stats: " + json.dumps(snap), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
