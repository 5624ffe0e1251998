"""Several devices: the sharded search step, the sharded and ring
all-vs-all triangles, multi-process start-up.

Port of the JAX package's ``parallel/dist.py``.  JAX runs one program
over a ``("db", "batch")`` mesh with ``shard_map``; here every rank is a
process on one device (``parallel/mesh.py``), every rank calls the same
function with the same arguments and every rank gets the same result.
The collectives go through ``torch.distributed``: NCCL on the card (the
default), gloo when the caller asks for the CPU, or gloo for several
ranks that share one card (their tensors stage through host memory):

* the reference store is sharded over ``db`` and the queries over
  ``batch``; each rank screens its [R_local, Q_local] block, chains only
  the passing pairs (``chain_pairs``) and all-gathers the block's planes
  into [R, Q] on every rank, with global counts from ``all_reduce``;
* the all-vs-all triangle runs its ``chain_block`` tiles round robin over
  the ranks (``sharded_triangle``, the stack on every rank), or keeps one
  block of the stack per rank and passes the blocks round a ring of
  point-to-point sends (``ring_triangle``, two blocks per rank whatever
  the stack's size);
* ``initialize_multihost`` joins a process group (TCP rendezvous, or the
  environment ``torchrun`` sets) and :func:`launch` spawns the ranks of a
  world on one machine.

The chain DP of every rank is the CUDA kernel (``ops/chain_dp.py``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..engine.batch import check_overflow, pairs_ani, take_sketch
from ..ops.chain import ChainConfig, EngineBudgets, chain_block, chain_pairs
from ..ops.chain import rcid_bits_for
from ..ops.screen import screen_batch
from ..ops.sketch import FIELDS, DeviceSketch, round_up
from .mesh import Mesh, make_mesh  # noqa: F401  (re-export, as in JAX)

# the planes of one chain_pairs call: name -> dtype
_PAIR_PLANES = dict(
    ani_mean=torch.float32, ani_robust=torch.float32,
    ani_median=torch.float32, af_query=torch.float32, af_ref=torch.float32,
    n_fragments=torch.int32, n_anchors=torch.int32,
    anchors_overflow=torch.bool, frag_overflow=torch.bool)
_CI_PLANES = dict(ani_ci_low=torch.float32, ani_ci_high=torch.float32)


def _tree_map(fn, tree):
    if isinstance(tree, DeviceSketch):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def shard_leading(mesh: Mesh, tree, axis):
    """This rank's contiguous block of the leading axis of every tensor of
    ``tree`` (a ``DeviceSketch``, a dict of tensors or one tensor), on the
    rank's device: block ``i`` of ``n`` for the rank's coordinate ``i`` on
    ``axis`` (a name, or a tuple of names flattened), the JAX package's
    ``P(axis)`` placement.  Each block is a copy, never a view, so the
    whole of ``x`` is not kept alive by it.  The leading axis must divide
    by ``n``."""
    i, n = mesh.axis_coord(axis)

    def block(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} does not divide "
                             f"over {n} blocks of mesh axis {axis!r}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b].to(mesh.device, copy=True)
    return _tree_map(block, tree)


def replicate(mesh: Mesh, tree):
    """The whole of ``tree`` on this rank's device."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


# ---- collectives over the whole world, on the mesh's transport ----

def _all_gather(mesh: Mesh, tensors: Dict[str, torch.Tensor]
                ) -> List[Dict[str, torch.Tensor]]:
    """Every rank's ``tensors`` (same keys, shapes and dtypes on every
    rank), in rank order, on this rank's device.  Floats travel as one
    f32 buffer and the rest as one int64 buffer: two collectives."""
    if not mesh.distributed:
        return [tensors]
    keys = sorted(tensors)
    out = [dict() for _ in range(mesh.size)]
    for is_float in (True, False):
        group = [k for k in keys if tensors[k].is_floating_point() == is_float]
        if not group:
            continue
        wire = torch.float32 if is_float else torch.int64
        flat = torch.cat([tensors[k].reshape(-1).to(wire) for k in group]
                         ).to(mesh.transport)
        bufs = [torch.empty_like(flat) for _ in range(mesh.size)]
        dist.all_gather(bufs, flat)
        for r, buf in enumerate(bufs):
            buf = buf.to(mesh.device)
            lo = 0
            for k in group:
                t = tensors[k]
                out[r][k] = buf[lo:lo + t.numel()].reshape(t.shape).to(t.dtype)
                lo += t.numel()
    return out


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    if not mesh.distributed:
        return t
    x = t.to(mesh.transport)
    dist.all_reduce(x)
    return x.to(t.device)


def _all_gather_object(mesh: Mesh, obj) -> list:
    if not mesh.distributed:
        return [obj]
    objs = [None] * mesh.size
    dist.all_gather_object(objs, obj)
    return objs


def _ring_shift(mesh: Mesh, sk: DeviceSketch) -> DeviceSketch:
    """The sketch block of rank ``rank + 1`` (mod the world): every rank
    sends its block to ``rank - 1`` and receives from ``rank + 1`` (the
    JAX ``ppermute`` shift), all fields packed in one byte buffer."""
    parts = [getattr(sk, f).contiguous().reshape(-1).view(torch.uint8)
             for f in FIELDS]
    send = torch.cat(parts).to(mesh.transport)
    recv = torch.empty_like(send)
    D, r = mesh.size, mesh.rank
    ops = [dist.P2POp(dist.isend, send, (r - 1) % D),
           dist.P2POp(dist.irecv, recv, (r + 1) % D)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    recv = recv.to(mesh.device)
    fields, lo = {}, 0
    for f, p in zip(FIELDS, parts):
        t = getattr(sk, f)
        fields[f] = recv[lo:lo + p.numel()].clone().view(t.dtype).reshape(
            t.shape)
        lo += p.numel()
    return DeviceSketch(**fields)


# ---- the sharded many-to-many search step ----

def make_sharded_search(mesh: Mesh, cfg: ChainConfig, budgets: EngineBudgets,
                        screen_val: float = 0.8, marker_k: int = 21,
                        rescue_small: bool = True, chunk: int = 4):
    """The many-to-many search step of one rank.

    ``step(refs, queries)`` takes this rank's blocks (``shard_leading``
    over "db" and "batch") of a stacked reference and query store.  The
    rank screens all its [R_l, Q_l] pairs (``ops/screen.py``), chains the
    passing pair ids in ascending order with ``chain_pairs``, ``chunk``
    pairs per call, and leaves 0 on every plane of a pair that did not
    pass.  Returns, on every rank, a dict of [R, Q] tensors (the blocks
    all-gathered) with ``screen_pass``, and the mesh-wide ``total_hits``
    and ``n_chained`` ([1] int32, ``all_reduce`` sums)."""
    planes = dict(_PAIR_PLANES, **(_CI_PLANES if cfg.est_ci else {}))

    def step(refs: DeviceSketch, queries: DeviceSketch) -> dict:
        dev = refs.kmers.device
        Rl, Ql = refs.kmers.shape[0], queries.kmers.shape[0]
        passes = torch.stack([screen_batch(
            queries.markers_hi[j], queries.markers_lo[j],
            queries.n_markers[j], refs.markers_hi, refs.markers_lo,
            refs.n_markers, screen_val, marker_k=marker_k,
            rescue_small=rescue_small)[0] for j in range(Ql)], dim=1)
        pid = torch.nonzero(passes.reshape(-1)).reshape(-1)
        out = {k: torch.zeros(Rl * Ql, dtype=t, device=dev)
               for k, t in planes.items()}
        for lo in range(0, pid.shape[0], chunk):
            pc = pid[lo:lo + chunk]
            res = chain_pairs(take_sketch(refs, pc // Ql),
                              take_sketch(queries, pc % Ql), cfg=cfg,
                              budgets=budgets)
            if set(res) != set(planes):
                raise RuntimeError(f"chain_pairs planes {sorted(res)} are "
                                   f"not the step's {sorted(planes)}")
            for k in planes:
                out[k][pc] = res[k]
        out = {k: v.reshape(Rl, Ql) for k, v in out.items()}
        out["screen_pass"] = passes
        hits = ((out["ani_mean"] > 0.1) & passes).sum()
        counts = _all_reduce_sum(mesh, torch.stack(
            [hits, torch.tensor(pid.shape[0], device=dev)]).to(torch.int64))
        blocks = _all_gather(mesh, out)
        nb = mesh.shape["batch"]
        full = {k: torch.cat([torch.cat([blocks[i * nb + j][k]
                                         for j in range(nb)], dim=1)
                              for i in range(mesh.shape["db"])], dim=0)
                for k in out}
        full["total_hits"] = counts[0:1].to(torch.int32)
        full["n_chained"] = counts[1:2].to(torch.int32)
        return full
    return step


# ---- all-vs-all ----

def _giant_mask(batch: DeviceSketch) -> np.ndarray:
    """Per-genome bool mask: contigs beyond the packed block-grid range or
    totals >= 2^30 bp (both take the full-range per-pair pipeline)."""
    cl = batch.contig_lengths.to(torch.int64).cpu()
    cap = 1 << (32 - rcid_bits_for(cl.shape[1]))
    return ((cl.max(dim=1).values >= cap) |
            (cl.sum(dim=1) >= (1 << 30))).numpy()


def _assemble(G: int, parts) -> tuple:
    """(ri, qi, dict of [P] arrays) in ``np.triu_indices`` order from
    (ref idx, query idx, dict of arrays) parts; a key that one part lacks
    reads 0 for its pairs."""
    mats = {}
    for ri_p, qi_p, res in parts:
        for key, val in res.items():
            arr = np.asarray(val)
            if key not in mats:
                mats[key] = np.zeros((G, G), arr.dtype)
            mats[key][ri_p, qi_p] = arr
    ri, qi = np.triu_indices(G, k=1)
    return ri, qi, {k: v[ri, qi] for k, v in mats.items()}


def _triangle_with_giants(batch: DeviceSketch, mesh: Mesh, mask: np.ndarray,
                          clean_fn, *, cfg: ChainConfig,
                          budgets: EngineBudgets, **kw):
    """The triangle of a stack that holds giant genomes: the other genomes
    through ``clean_fn`` (the mesh path), every pair touching a giant
    through ``pairs_ani`` (full range), merged in triu order.  A key that
    one path lacks reads 0 for the other path's pairs, as in the JAX
    package and ``engine.batch.triangle``, so the two triangles agree key
    for key.  The giant pairs are few and every rank computes them all.
    ``budgets.max_fragments`` must cover the giants' fragment counts:
    ``check_overflow`` raises on ``frag_overflow``."""
    G = batch.kmers.shape[0]
    giants = set(np.nonzero(mask)[0].tolist())
    keep = np.array([i for i in range(G) if i not in giants], np.int64)
    batch = replicate(mesh, batch)
    parts = []
    if len(keep) >= 2:
        sub = take_sketch(batch, torch.as_tensor(keep, device=batch.device))
        ri_s, qi_s, res_s = clean_fn(sub, mesh, cfg=cfg, budgets=budgets,
                                     **kw)
        parts.append((keep[ri_s], keep[qi_s], res_s))
    fb = [(i, j) for i in range(G) for j in range(i + 1, G)
          if i in giants or j in giants]
    if fb:
        ri_f, qi_f = (np.array(x, np.int64) for x in zip(*fb))
        out = {k: v.cpu().numpy() for k, v in pairs_ani(
            batch, ri_f, qi_f, cfg=cfg, budgets=budgets).items()}
        check_overflow(out, budgets)
        parts.append((ri_f, qi_f, out))
    return _assemble(G, parts)


def sharded_triangle(batch: DeviceSketch, mesh: Mesh, *, cfg: ChainConfig,
                     budgets: EngineBudgets, block: int = 8,
                     anchors_per_pair: Optional[int] = None):
    """All-vs-all ANI over a genome stack, its tiles spread over the mesh.

    The strict upper triangle is tiled into ``block`` x ``block``
    ``chain_block`` tiles (``block`` halved until it fits the pair-grid
    limit; a tile's last rows and columns padded with its first genome;
    diagonal tiles computed whole).  Tile ``t`` runs on rank
    ``t % world``; the tile count is padded to a multiple of the world
    with copies of tile 0, so every rank runs as many tiles.  The tiles
    are all-gathered and assembled in triu order, then
    ``check_overflow``.  Each rank holds the whole stack.  Returns
    (ref_idx, query_idx, dict of [P] numpy arrays), as
    ``engine.batch.triangle`` does; giant genomes reroute as there."""
    mask = _giant_mask(batch)
    if mask.any():
        return _triangle_with_giants(
            batch, mesh, mask, sharded_triangle, cfg=cfg, budgets=budgets,
            block=block, anchors_per_pair=anchors_per_pair)

    G = batch.kmers.shape[0]
    world = mesh.size
    while block > 1 and block * block * budgets.max_fragments > (1 << 17):
        block //= 2
    app = anchors_per_pair or budgets.max_anchors
    # diagonal tiles also join their self-pairs (discarded on assembly),
    # and a self-pair's anchor count is the full seed count: two extra
    # per-pair shares per row of headroom
    total = round_up(block * (block + 2) * app, 8192)

    starts = list(range(0, G, block))
    tiles = []   # (ridx, qidx, rpad, qpad)
    for a in starts:
        for b in starts:
            if b < a:
                continue
            ridx = np.arange(a, min(a + block, G))
            qidx = np.arange(b, min(b + block, G))
            rpad = np.concatenate([ridx, np.full(block - len(ridx), ridx[0])])
            qpad = np.concatenate([qidx, np.full(block - len(qidx), qidx[0])])
            tiles.append((ridx, qidx, rpad, qpad))
    T = len(tiles)
    Tp = -(-T // world) * world
    batch = replicate(mesh, batch)
    dev = batch.device
    outs = []
    for t in range(mesh.rank, Tp, world):
        _, _, rpad, qpad = tiles[t if t < T else 0]
        outs.append(chain_block(
            take_sketch(batch, torch.as_tensor(rpad, device=dev)),
            take_sketch(batch, torch.as_tensor(qpad, device=dev)),
            cfg=cfg, budgets=budgets, total_anchors=total))
    mine = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    ranks = [{k: v.cpu().numpy() for k, v in r.items()}
             for r in _all_gather(mesh, mine)]
    parts = []
    for t, (ridx, qidx, _, _) in enumerate(tiles):
        tile = {k: v[t // world][:len(ridx), :len(qidx)]
                for k, v in ranks[t % world].items()}
        rr, qq = np.meshgrid(ridx, qidx, indexing="ij")
        parts.append((rr, qq, tile))
    ri, qi, result = _assemble(G, parts)
    check_overflow(result, budgets)
    return ri, qi, result


def ring_triangle(batch: DeviceSketch, mesh: Mesh, *, cfg: ChainConfig,
                  budgets: EngineBudgets,
                  anchors_per_pair: Optional[int] = None):
    """Memory-scalable all-vs-all: genome blocks pass round a ring.

    The stack is split into D = world blocks of ``ceil(G / D)`` genomes
    (padded with genome 0), one per rank.  Each rank chains its block
    against itself, then in rounds ``s = 1 .. D // 2`` receives the block
    of rank ``rank + s`` (a one-step shift of the visiting block per round,
    ``batch_isend_irecv``) and chains the two, the block with the smaller
    ids as the reference (the single-device orientation), so each rank
    holds two blocks whatever G is.  Every unordered block pair is covered;
    when D is even the last round's pairs are computed twice, identically.
    Raises ``ValueError`` when a block's pair grid passes 2^17 rows, as
    the JAX package does.  Returns (ref_idx, query_idx, dict of [P] numpy
    arrays) in triu order; giant genomes reroute as in
    :func:`sharded_triangle`."""
    mask = _giant_mask(batch)
    if mask.any():
        return _triangle_with_giants(
            batch, mesh, mask, ring_triangle, cfg=cfg, budgets=budgets,
            anchors_per_pair=anchors_per_pair)

    G = batch.kmers.shape[0]
    D = mesh.size
    Bl = -(-G // D)
    if Bl * Bl * budgets.max_fragments > (1 << 17):
        raise ValueError(
            f"block of {Bl} genomes exceeds the pair-grid limit; use "
            f"more devices or smaller max_fragments")
    app = anchors_per_pair or budgets.max_anchors
    total = round_up(Bl * (Bl + 2) * app, 8192)
    S = D // 2

    d = mesh.rank
    idx = np.arange(d * Bl, (d + 1) * Bl)
    idx[idx >= G] = 0                     # padding: genome 0, discarded
    mine = take_sketch(batch, torch.as_tensor(idx, device=batch.device)
                       ).map(lambda x: x.to(mesh.device))
    outs = [chain_block(mine, mine, cfg=cfg, budgets=budgets,
                        total_anchors=total)]
    buf = mine
    for s in range(1, S + 1):
        buf = _ring_shift(mesh, buf)      # now the block of rank d + s
        e = (d + s) % D
        r_in, q_in = (mine, buf) if d < e else (buf, mine)
        outs.append(chain_block(r_in, q_in, cfg=cfg, budgets=budgets,
                                total_anchors=total))
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    ranks = [{k: v.cpu().numpy() for k, v in r.items()}
             for r in _all_gather(mesh, stacked)]
    parts = []
    for d_ in range(D):
        for s in range(S + 1):
            e = (d_ + s) % D
            lo_b, hi_b = min(d_, e), max(d_, e)
            ridx = np.arange(lo_b * Bl, (lo_b + 1) * Bl)
            qidx = np.arange(hi_b * Bl, (hi_b + 1) * Bl)
            rk, qk = ridx < G, qidx < G
            tile = {k: v[s][np.ix_(rk, qk)] for k, v in ranks[d_].items()}
            rr, qq = np.meshgrid(ridx[rk], qidx[qk], indexing="ij")
            parts.append((rr, qq, tile))
    ri, qi, result = _assemble(G, parts)
    check_overflow(result, budgets)
    return ri, qi, result


# ---- start-up ----

def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda") -> None:
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id``, with the rendezvous at ``tcp://<coordinator>``
    (``host:port``).  Left out, each is read from the environment that
    ``torchrun`` sets (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as the JAX package auto-detects its pod.  On ``cuda``
    (the default) the backend is NCCL and the rank's card, its
    ``LOCAL_RANK`` (else its rank) modulo the cards present, is made the
    current device first, so that every later ``"cuda"`` means it; on
    ``cpu`` the backend is gloo."""
    env = os.environ
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device: str, inbox, results) -> None:
    # the ranks of one machine share its cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        fn, args = inbox.get()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world: int, args: Sequence = (), *, device="cuda",
           timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group and
    return each rank's result, in rank order.

    ``device="cuda"``: rank ``r`` computes on card ``r`` over NCCL (the
    machine needs ``world`` cards).  ``"cpu"``: every rank on the CPU over
    gloo.  ``"cuda:N"``: every rank on card N, the collectives over gloo
    through host memory (NCCL refuses two ranks on one card).  ``fn`` is
    sent by import path.  The rendezvous is a file in a fresh temporary
    folder, so concurrent launches never share a port.  A rank that fails
    or a world that outlives ``timeout`` seconds stops every rank and
    raises ``RuntimeError`` with the rank's traceback."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA devices, "
                               f"found {torch.cuda.device_count()}")
        backend = "nccl"
    else:
        backend = "gloo"
    ctx = mp.get_context("spawn")
    # the work goes through a queue, not the process arguments: a rank
    # that dies while starting never leaves the parent blocked on a pipe
    inbox, results = ctx.Queue(), ctx.Queue()
    folder = tempfile.mkdtemp(prefix="pyskani_launch_")
    init_method = f"file://{os.path.join(folder, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, init_method, backend, str(device), inbox, results))
        for r in range(world)]
    out = {}
    try:
        for p in procs:
            inbox.put((fn, tuple(args)))
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    try:     # a failed rank reports before it exits
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        what = (f"rank {dead[0][0]} exited with code "
                                f"{dead[0][1]}" if dead else
                                f"{world - len(out)} of {world} ranks did "
                                f"not finish in {timeout} s")
                        raise RuntimeError(f"launch: {what}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        for q in (inbox, results):
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(folder, ignore_errors=True)
    return [out[r] for r in range(world)]
