"""End-to-end sharded database search: Database x mesh of ranks.

Port of the JAX package's ``parallel/search.py``: the reference store is
sharded over the mesh's ``db`` axis, query genomes go through the
``batch`` axis in fixed-size groups, and each rank screens, shortlists
and chains only the passing pairs of its block (``make_sharded_search``).
Every rank builds the searcher over the same store and calls
:meth:`ShardedDatabaseSearch.query_many` with the same queries; every
rank gets the same hits.

Memory stays bounded on both sides: over a memory store the searcher
stacks only this rank's ``db`` shard on the device (the Database's own
sketches stay where the Database keeps them), and an ``open()`` store
streams through the mesh in chunks of
``db * stream_refs_per_device`` sketches, each rank decoding only its own
rows of a chunk.  Each rank
sketches only its own queries of a group.  The chunks run one after the
other: the step syncs with the host (the passing pairs' count), so a
queued next chunk would not overlap it.

Two faults of the JAX searcher are not carried over: the aligned-fraction
floor is ``CommandParams().min_aligned_frac``, as ``Database.query``
takes it (the JAX searcher writes 0.15), and the ``frag_overflow`` plane
is gathered and ``check_overflow`` raises on it (the JAX searcher drops
it, so truncated fragments pass silently).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import regression
from ..engine.batch import check_overflow, stack_sketches
from ..engine.stream import stage_chunk
from ..hit import Hit
from ..ops.chain import EngineBudgets
from ..ops.sketch import (contig_budget_for, marker_budget_for, round_up,
                          seed_budget_for, sketch_genomes_device)
from ..params import (MIN_ANI_KEEP, MIN_LENGTH_CONTIG, CommandParams,
                      SEARCH_ANI_CUTOFF_DEFAULT)
from .dist import _all_gather_object, make_sharded_search
from .mesh import Mesh


class ShardedDatabaseSearch:
    """Reusable sharded searcher over a Database's reference store.

    Build once on every rank (over a memory store it also places this
    rank's shard of the stacked store, and only that, on its device), then
    call
    :meth:`query_many` with lists of query genomes.

    ``stream_refs_per_device`` bounds per-rank reference memory: the store
    is processed in chunks of ``db * stream_refs_per_device`` sketches.
    It defaults to streaming for disk-backed stores (8 refs per rank per
    chunk) and to the one placed shard for memory stores; pass a value to
    chunk either way.
    """

    def __init__(self, database, mesh: Mesh, *, chunk: int = 4,
                 queries_per_device: int = 1,
                 cutoff: Optional[float] = None,
                 learned_ani: Optional[bool] = None,
                 median: bool = False, robust: bool = False,
                 faster_small: bool = False,
                 stream_refs_per_device: Optional[int] = None):
        from ..db.storage import MemoryStorage

        self._db = database
        self._mesh = mesh
        self._median = median
        self._robust = robust
        self._cutoff = cutoff
        self._faster_small = faster_small
        self._learned_arg = learned_ani
        ndb = mesh.shape["db"]
        self._ndb = ndb
        self._qpd = queries_per_device
        self._qg = mesh.shape["batch"] * queries_per_device

        markers = database._markers
        names = [os.path.basename(m.name) for m in markers]
        self._names = names
        self._R = len(names)
        in_memory = isinstance(database._storage, MemoryStorage)
        if stream_refs_per_device is None and not in_memory:
            stream_refs_per_device = 8
        self._streaming = stream_refs_per_device is not None

        if self._streaming:
            # budgets from the markers' lengths: no sketch is loaded here
            tl = max(m.total_len for m in markers)
            self._bucket = seed_budget_for(tl, database._params.c)
            self._mbucket = marker_budget_for(tl, database._params.marker_c)
            self._cb = max(contig_budget_for(len(m.contig_lengths))
                           for m in markers)
            # never a chunk larger than the store (a small store would pad
            # to db * stream_refs_per_device copies)
            rc = ndb * min(stream_refs_per_device,
                           max(1, -(-self._R // ndb)))
            self._ref_name_chunks = [names[i:i + rc]
                                     for i in range(0, len(names), rc)]
            self._rchunk = rc
            self._refs = None
        else:
            # the budgets of Database._ref_stack, without its whole-store
            # stack on the device: this rank stacks only its own rows
            refs = [database._storage.load(n) for n in names]
            counts = torch.stack([torch.stack([r.device.n_seeds,
                                               r.device.n_markers,
                                               r.device.n_contigs])
                                  for r in refs]).cpu()
            self._bucket = round_up(int(counts[:, 0].max()), 8192)
            self._mbucket = round_up(int(counts[:, 1].max()), 512)
            self._cb = max(contig_budget_for(int(c)) for c in counts[:, 2])
            # one chunk of the whole store, its tail padded with row 0
            self._rchunk = -(-self._R // ndb) * ndb
            self._ref_name_chunks = [names]
            mine = stack_sketches(
                [database._storage.load(n) for n in self._rank_rows(names)],
                self._bucket, self._mbucket, self._cb)
            self._refs = mine.map(lambda t: t.to(mesh.device))

        fl = database._chain_cfg.fragment_length
        self._fl = fl
        # fragments are per contig (every contig gives at least one)
        nf = round_up(max(sum(max(1, -(-L // fl)) for L in m.contig_lengths)
                          for m in markers) + 2, 128)
        self._nf = nf
        self._budgets = EngineBudgets(
            max_anchors=round_up(int(self._bucket * 1.5) + 4096, 8192),
            max_fragments=nf, max_anchors_per_fragment=256)
        screen_val = cutoff if cutoff is not None \
            else SEARCH_ANI_CUTOFF_DEFAULT
        self._learned = learned_ani if learned_ani is not None else \
            regression.use_learned_ani(database._params.c, False, False,
                                       median)
        self._model = regression.get_model(database._params.c, self._learned)
        self._step = make_sharded_search(
            mesh, database._chain_cfg, self._budgets,
            screen_val=screen_val,
            marker_k=database._params.marker_k,
            rescue_small=not faster_small, chunk=chunk)

    def _rank_rows(self, chunk_names: List[str]) -> List[str]:
        """This rank's names of one reference chunk: the chunk's ragged
        tail repeats its first reference (discarded)."""
        rl = self._rchunk // self._ndb
        i = self._mesh.coords["db"]
        return [chunk_names[j] if j < len(chunk_names) else chunk_names[0]
                for j in range(i * rl, (i + 1) * rl)]

    def _ref_chunk(self, chunk_names: List[str]):
        """This rank's rows of one streamed reference chunk, on its
        device."""
        store = self._db._storage
        hosts = [store.load(n) if store.path is None else
                 store.load(n, device="cpu")
                 for n in self._rank_rows(chunk_names)]
        return stage_chunk(hosts, self._mesh.device, self._bucket,
                           self._mbucket, self._cb)

    def _query_block(self, group):
        """This rank's queries of a group, sketched and stacked on its
        device: batch slot ``j`` of the rank holds group member
        ``batch_coord * queries_per_device + j``, or the group's first
        query past the group's end (discarded)."""
        lo = self._mesh.coords["batch"] * self._qpd
        own = [group[s] if s < len(group) else group[0]
               for s in range(lo, lo + self._qpd)]
        sk = sketch_genomes_device(own, self._db._params,
                                   device=self._mesh.device)
        return stack_sketches(
            sk, max(self._bucket, max(s.device.seed_budget for s in sk)),
            max(self._mbucket, max(s.device.marker_budget for s in sk)))

    def query_many(self, named_queries: Sequence[Tuple[str, Sequence[bytes]]]
                   ) -> List[List[Hit]]:
        """Hits for each (name, [contig bytes...]) query genome, in input
        order, the same on every rank.

        A query with more fragments than the searcher's store-sized budget
        (e.g. a multi-Gbp genome) takes ``Database.query``, which sizes
        budgets per query: such queries are spread round robin over the
        ranks and their hits all-gathered.  The others go through the mesh
        in groups of ``batch * queries_per_device``."""
        db = self._db
        mesh = self._mesh
        all_items = list(named_queries)

        def _nfrag(contigs) -> int:
            return sum(max(1, -(-len(c) // self._fl)) for c in contigs
                       if len(c) >= MIN_LENGTH_CONTIG)

        fb_slots = [i for i, (_, cs) in enumerate(all_items)
                    if _nfrag(cs) + 2 > self._nf]
        mine = {}
        for i in fb_slots[mesh.rank::mesh.size]:
            nm, cs = all_items[i]
            mine[i] = db.query(
                nm, *cs, learned_ani=self._learned_arg,
                median=self._median, robust=self._robust,
                cutoff=self._cutoff, faster_small=self._faster_small)
        results_by_slot: dict = {}
        if fb_slots:
            for part in _all_gather_object(mesh, mine):
                results_by_slot.update(part)
        items = [it for i, it in enumerate(all_items)
                 if i not in results_by_slot]
        reg_slots = [i for i in range(len(all_items))
                     if i not in results_by_slot]
        if not items:
            return [results_by_slot[i] for i in range(len(all_items))]

        qg = self._qg
        groups = [items[lo:lo + qg] for lo in range(0, len(items), qg)]
        qblocks = [self._query_block(g) for g in groups]
        keys = ("ani_mean", "ani_robust", "ani_median", "af_query",
                "af_ref", "screen_pass", "anchors_overflow", "frag_overflow")
        # planes[g][k]: the full [R, qg] result of query group g
        planes = [{k: [] for k in keys} for _ in groups]
        for names in self._ref_name_chunks:
            refs = self._ref_chunk(names) if self._streaming else self._refs
            for g, qsh in enumerate(qblocks):
                out = self._step(refs, qsh)
                for k in keys:
                    planes[g][k].append(out[k][:len(names)].cpu().numpy())
        planes = [{k: np.concatenate(v) for k, v in p.items()} for p in planes]

        key = "ani_median" if self._median else \
            "ani_robust" if self._robust else "ani_mean"
        maf = CommandParams().min_aligned_frac
        # a clipped anchor pool or anchors past the fragment budget in any
        # chunk: warn or raise as every other path does
        check_overflow({k: np.concatenate([p[k].reshape(-1) for p in planes])
                        for k in ("anchors_overflow", "frag_overflow")},
                       self._budgets)
        # the learned correction: one batch per group over its screened
        # pairs, on this rank's device
        use_model = self._model is not None and not self._median \
            and not self._robust
        out_hits: List[List[Hit]] = []
        for g, group in enumerate(groups):
            cols = slice(0, len(group))
            sp = planes[g]["screen_pass"][:self._R, cols].astype(bool)
            ani, afq, afr = (planes[g][k][:self._R, cols].astype(np.float64)
                             for k in (key, "af_query", "af_ref"))
            if use_model:
                ri, qi = np.nonzero(sp)
                ani[ri, qi] = regression.apply_model_batch(
                    self._model, ani[ri, qi], afq[ri, qi], afr[ri, qi],
                    self._mesh.device)
            keep = sp & ~((afq < maf) & (afr < maf)) & (ani > MIN_ANI_KEEP)
            for qi, (qname, _) in enumerate(group):
                out_hits.append([
                    Hit(min(max(float(ani[ri, qi]), 0.0), 1.0), qname,
                        float(afq[ri, qi]), self._names[ri],
                        float(afr[ri, qi]))
                    for ri in np.nonzero(keep[:, qi])[0]])
        for slot, hits in zip(reg_slots, out_hits):
            results_by_slot[slot] = hits
        return [results_by_slot[i] for i in range(len(all_items))]
