"""Rank functions for the port's mesh tests.

``pyskani_tpu_torch.parallel.dist.launch`` spawns the ranks and sends
them these functions by import path, so this module imports only the
port (never JAX, never the JAX package, never ``conftest``).  Sketches
arrive as dicts of numpy arrays in the JAX package's dtypes
(``convert.sketch_from_numpy``), stores as folders, genomes as bytes.
"""

import time

import torch

from pyskani_tpu_torch import convert
from pyskani_tpu_torch.ops.chain import ChainConfig, EngineBudgets
from pyskani_tpu_torch.ops.sketch import FIELDS


def _stack(fields):
    return convert.sketch_from_numpy(fields, "stack", [], [],
                                     device="cpu").device


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def mesh_cases(cases):
    """make_mesh(db, batch) per case: ((db, batch), this rank's coords)
    or the ValueError's message."""
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    out = []
    for db, batch in cases:
        try:
            m = make_mesh(db, batch, device="cpu")
            out.append(((m.shape["db"], m.shape["batch"]), m.coords))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    return out


def search_step(shape, refs, queries, budgets, chunk):
    """One ``make_sharded_search`` step on stacks sharded over the mesh."""
    from pyskani_tpu_torch.parallel.dist import (make_sharded_search,
                                                 shard_leading)
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(*shape, device="cpu")
    step = make_sharded_search(mesh, ChainConfig(), EngineBudgets(**budgets),
                               chunk=chunk)
    return _numpy(step(shard_leading(mesh, _stack(refs), "db"),
                       shard_leading(mesh, _stack(queries), "batch")))


def searcher_hits(shape, path, opener, queries, kw):
    """``ShardedDatabaseSearch`` over the store at ``path`` (``load`` or
    ``open``): the hits as (ref, identity, query fraction, ref fraction)
    and the number of reference chunks."""
    from pyskani_tpu_torch import Database
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    from pyskani_tpu_torch.parallel.search import ShardedDatabaseSearch
    db = getattr(Database, opener)(path, device="cpu")
    mesh = make_mesh(*shape, device="cpu")
    s = ShardedDatabaseSearch(db, mesh, **kw)
    placed = _placed(s)
    hits = [[(h.reference_name, h.identity, h.query_fraction,
              h.reference_fraction) for h in hs]
            for hs in s.query_many(queries)]
    return hits, len(s._ref_name_chunks), placed


def _placed(s):
    """A memory searcher's placed shard, as built: (its rows, the bytes
    its tensors' storages hold, the bytes of the rows, whether the
    Database cached a whole-store stack); None for a streamed
    searcher."""
    if s._refs is None:
        return None
    fields = [getattr(s._refs, f) for f in FIELDS]
    return (s._refs.kmers.shape[0],
            sum(t.untyped_storage().nbytes() for t in fields),
            sum(t.nbytes for t in fields), s._db._stack_cache is not None)


def triangle(shape, fn, batch, budgets, kw):
    """``sharded_triangle`` or ``ring_triangle`` of a stack."""
    from pyskani_tpu_torch.parallel import dist
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(*shape, device="cpu")
    ri, qi, out = getattr(dist, fn)(_stack(batch), mesh, cfg=ChainConfig(),
                                    budgets=EngineBudgets(**budgets), **kw)
    return ri, qi, out


def triangle_error(shape, fn, batch, budgets, kw, cfg_kw):
    """The ``RuntimeError`` message of ``triangle`` under ``ChainConfig(
    **cfg_kw)``, or None if it returned."""
    from pyskani_tpu_torch.parallel import dist
    from pyskani_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(*shape, device="cpu")
    try:
        getattr(dist, fn)(_stack(batch), mesh, cfg=ChainConfig(**cfg_kw),
                          budgets=EngineBudgets(**budgets), **kw)
    except RuntimeError as e:
        return str(e)
    return None


def run_all(jobs):
    """Run the jobs ({key: (function name, args)}) in order; {key: result}.
    The ranks of a test share the machine with the other tests: one
    thread each."""
    torch.set_num_threads(1)
    return {key: globals()[name](*args) for key, (name, args) in jobs.items()}


def fail():
    raise ValueError("rank failed on purpose")


def sleep():
    time.sleep(120)
