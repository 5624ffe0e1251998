"""Database: the pyskani-compatible user API over the PyTorch engine.

Port of the JAX package's ``database.py``: the same constructor
defaults, storage formats, exceptions and context-manager semantics;
``sketch``, ``sketch_many`` (batched sketching of many genomes) and
``query`` (batched marker screen, then the chain pipelines over the
shortlist, then the regression and aligned-fraction filters, then
``Hit``, with the bootstrap interval under ``est_ci=True``).
Shortlisted references chain on the packed block pipeline
(``chain_block``) unless they or the query lie past its position range
(``ops.chain.packed_cap``, ``MAX_PACKED_TOTAL``): those pairs take the
full-range per-pair pipeline (``chain_pairs``).  Genomes above the
single-call sketch buffer are sketched in chunks.

Stores live in memory, or on disk (``Database(path)``, ``save``):
``open`` keeps only the markers in RAM and streams the shortlisted
sketches to the device chunk by chunk for each query
(``engine/stream.py``); ``load`` reads every sketch onto the device.
Tensors live on ``device``, which is the card unless the caller passes
``device="cpu"``; there is no silent fallback to the CPU.  Every
4 <= k <= 32 works (``Database(k=...)``, and ``open`` of such a store);
k outside that range raises ``ValueError``, as in the JAX package.

With profiling on (``utils/profiling.py``), ``sketch``, ``sketch_many``
and ``query`` time the JAX package's scopes (``sketch``, ``screen``,
``chain``) and add to its counters (``bases_sketched``,
``refs_screened``, ``screen_passed``, ``pairs_chained``).  ``query``
also times its host stages on the host clock: ``query/shortlist`` (the
screen's passes to names, the partition and the budgets),
``query/merge`` (the chain outputs' copies and the overflow check) and
``query/correct`` (the learned correction, the filters and the
``Hit``s), and counts ``hits_corrected`` (rows corrected),
``correct_batches`` (calls of ``regression.apply_model_batch`` with at
least one row: one per query the correction reached) and
``hits_returned``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import List, Optional, Union

import numpy as np
import torch

from .db.storage import (ConsolidatedStorage, FolderStorage, MarkerSketch,
                         MemoryStorage, load_index, load_markers)
from .engine.batch import (block_chunk, check_overflow, engine_budgets,
                           one_vs_many, one_vs_many_pairs, repad_sketch,
                           stack_buckets, stack_sketches)
from .engine.stream import stream_one_vs_many
from .hit import Hit, screened_hits
from .ops.chain import (MAX_PACKED_TOTAL, ChainConfig, EngineBudgets,
                        packed_cap)
from .ops.screen import screen_batch
from .ops.sketch import (HostSketch, contig_budget_for, marker_budget_for,
                         round_up, seed_budget_for, sketch_genome_device,
                         sketch_genomes_device)
from .params import SEARCH_ANI_CUTOFF_DEFAULT, SketchParams
from .utils import profiling

_Sequence = Union[str, bytes, bytearray, memoryview]


def _as_bytes(contig: _Sequence) -> bytes:
    """Accept str/bytes/bytearray/memoryview/buffer (pyskani's Text
    semantics, utils.rs:74-102)."""
    if isinstance(contig, str):
        return contig.encode("utf-8")
    if isinstance(contig, (bytes, bytearray)):
        return bytes(contig)
    return bytes(memoryview(contig))


class Sketch:
    """A sketched genome (parity with pyskani's Sketch pyclass: name / c /
    amino_acid getters, no public constructor)."""

    def __init__(self, host_sketch: HostSketch, c: int,
                 amino_acid: bool = False):
        self._host = host_sketch
        self._c = c
        self._amino_acid = amino_acid

    @property
    def name(self) -> str:
        return self._host.name

    @property
    def c(self) -> int:
        return self._c

    @property
    def amino_acid(self) -> bool:
        return self._amino_acid

    def __repr__(self) -> str:
        return f"<Sketch name={self.name!r} c={self.c}>"


def _chain_cfg_for(params: SketchParams) -> ChainConfig:
    """Chain config derived from the sketch params: the ANI exponent is
    1/k and chain intervals extend by k-1."""
    return dataclasses.replace(ChainConfig(), k=params.k,
                               extend_right=params.k - 1)


def _partition_blockable(by_name, shortlist, query_total: int = 0):
    """Split a shortlist into (block_names, fb_names, cb, cap).

    ``block_names`` chain on the packed block pipeline whose contig bucket
    ``cb`` (max over block members) gives the position cap
    ``ops.chain.packed_cap(cb)``; ``fb_names`` exceed the cap and need the
    full-range per-pair pipeline.  Iterated to a fixed point.  Queries of
    ``MAX_PACKED_TOTAL`` bp or more route every reference to the
    full-range path."""
    if query_total >= MAX_PACKED_TOTAL:
        return [], list(shortlist), 8, packed_cap(8)
    block = list(shortlist)
    while True:
        cb = max((contig_budget_for(len(by_name[rn].contig_lengths))
                  for rn in block), default=8)
        cap = packed_cap(cb)
        viol = {rn for rn in block
                if max(by_name[rn].contig_lengths, default=0) >= cap}
        if not viol:
            break
        block = [rn for rn in block if rn not in viol]
    blocked = set(block)
    return block, [rn for rn in shortlist if rn not in blocked], cb, cap


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyskani_tpu_torch.Database runs on the GPU by default and "
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _make_folder(path) -> pathlib.Path:
    folder = pathlib.Path(os.fsdecode(path))
    if not folder.exists():
        try:
            folder.mkdir(parents=True)
        except OSError as err:
            raise OSError(err.errno, f"Failed to create {folder}") from None
    return folder


def _disk_storage(folder: pathlib.Path, format: Optional[str], device):
    fmt = format if format is not None else "consolidated"
    if fmt == "consolidated":
        return ConsolidatedStorage(folder, device=device)
    if fmt == "separated":
        return FolderStorage(folder, device=device)
    raise ValueError(f"invalid format: {fmt}")


class Database:
    """A database storing sketched genomes, on ``device``.

    The database contains two sketch collections with different
    compression levels: marker sketches (screening), always kept in
    memory, and genome sketches (chaining), in memory or in a folder."""

    def __init__(self, path=None, *, compression: int = 125,
                 marker_compression: int = 1000, k: int = 15,
                 format: Optional[str] = None, device=None):
        self._setup(device, SketchParams(
            c=compression, marker_c=marker_compression, k=k), [])
        if path is None:
            self._storage = MemoryStorage()
            return
        folder = _make_folder(path)
        if (folder / "markers.bin").exists():
            raise FileExistsError(str(folder / "markers.bin"))
        self._storage = _disk_storage(folder, format, self._device)

    @classmethod
    def open(cls, path, *, device=None) -> "Database":
        """Open a database folder, keeping only the markers in memory:
        each query streams its shortlisted sketches from disk."""
        folder = pathlib.Path(os.fsdecode(path))
        markers_path = folder / "markers.bin"
        if not markers_path.exists():
            raise OSError(2, f"Failed to open {markers_path}")
        self = cls.__new__(cls)
        self._setup(device, *load_markers(markers_path))
        if (folder / "index.db").exists() and \
                (folder / "sketches.db").exists():
            self._storage = ConsolidatedStorage(folder, load_index(folder),
                                                device=self._device)
        else:
            self._storage = FolderStorage(folder, device=self._device)
        return self

    def _setup(self, device, params: SketchParams,
               markers: List[MarkerSketch]) -> None:
        self._device = _resolve_device(device)
        self._params = params
        self._markers = markers
        self._chain_cfg = _chain_cfg_for(params)
        self._screen_cache = None
        self._stack_cache = None

    @classmethod
    def load(cls, path, *, device=None) -> "Database":
        """Open a database folder and read every sketch onto the device
        (fast queries, more memory)."""
        self = cls.open(path, device=device)
        mem = MemoryStorage()
        for marker in self._markers:
            mem.store(self._storage.load(os.path.basename(marker.name)),
                      self._params)
        self._storage = mem
        return self

    @property
    def path(self) -> Optional[pathlib.Path]:
        return self._storage.path

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def compression(self) -> int:
        return self._params.c

    @property
    def marker_compression(self) -> int:
        return self._params.marker_c

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> bool:
        self.flush()
        return False

    def sketch(self, name: str, *contigs: _Sequence, seed: bool = True) -> None:
        """Add a reference genome to the database.  ``seed=False`` skips
        seed-position recording: the sketch screens but never chains."""
        self._register_sketch(
            self._sketch(name, [_as_bytes(c) for c in contigs], seed))

    def _sketch(self, name: str, data, seed: bool) -> HostSketch:
        """One genome's sketch, on the Database's device."""
        with profiling.scope("sketch", self._device):
            host = sketch_genome_device(name, data, self._params, seed=seed,
                                        device=self._device)
        if profiling.enabled():
            profiling.stats().add("bases_sketched", sum(map(len, data)))
        return host

    def sketch_many(self, named_contigs) -> None:
        """Add many reference genomes, sketched in batched passes of up
        to 8 genomes of similar size; registered in input order.
        ``named_contigs`` is an iterable of (name, [contig, ...])."""
        items = [(name, [_as_bytes(c) for c in contigs])
                 for name, contigs in named_contigs]
        with profiling.scope("sketch", self._device):
            hosts = sketch_genomes_device(items, self._params,
                                          device=self._device)
        if profiling.enabled():
            profiling.stats().add(
                "bases_sketched", sum(len(c) for _, cs in items for c in cs))
        for host in hosts:
            self._register_sketch(host)

    def _register_sketch(self, host: HostSketch) -> None:
        """Register a sketch (made here or by ``convert.sketch_from_numpy``)."""
        with profiling.scope("register"):
            if host.device.device != self._device:
                host = dataclasses.replace(host, device=host.device.map(
                    lambda t: t.to(self._device)))
            dev = host.device
            m = int(dev.n_markers)
            self._markers.append(MarkerSketch(
                name=host.name, total_len=host.total_len,
                contig_names=host.contig_names,
                contig_lengths=list(host.lengths),
                hi=dev.markers_hi[:m].cpu().numpy().astype(np.uint32),
                lo=dev.markers_lo[:m].cpu().numpy().astype(np.uint32)))
            self._screen_cache = None
            self._stack_cache = None
            self._storage.store(host, self._params)

    def _marker_matrix(self):
        """Stacked, padded marker matrix [N, M] on the device."""
        if self._screen_cache is None:
            n = len(self._markers)
            M = round_up(max((len(m.hi) for m in self._markers), default=1),
                         512)
            hi = np.full((n, M), 0xFFFFFFFF, np.int64)
            lo = np.full((n, M), 0xFFFFFFFF, np.int64)
            counts = np.zeros(n, np.int32)
            for i, m in enumerate(self._markers):
                hi[i, :len(m.hi)] = m.hi
                lo[i, :len(m.lo)] = m.lo
                counts[i] = len(m.hi)
            self._screen_cache = tuple(torch.from_numpy(a).to(self._device)
                                       for a in (hi, lo, counts))
        return self._screen_cache

    def _budgets_for(self, query: HostSketch, shortlist=None) -> EngineBudgets:
        fl = self._chain_cfg.fragment_length
        # the fragment budget covers BOTH estimation grids: the query and
        # the longest shortlisted reference; past 384 it is bucketed to a
        # power of two, to limit the shapes a store's queries compile
        markers = self._markers if shortlist is None else \
            [m for m in self._markers
             if os.path.basename(m.name) in shortlist]
        nf_r = max((sum(max(1, -(-L // fl)) for L in m.contig_lengths)
                    for m in markers), default=1)
        budgets = engine_budgets(query.device.seed_budget,
                                 max(query.n_fragments(fl), nf_r))
        nf = budgets.max_fragments
        if nf > 384:
            p = 512
            while p < nf:
                p *= 2
            budgets = dataclasses.replace(budgets, max_fragments=p)
        return budgets

    def _store_buckets(self, names, streamed: bool):
        """(seed, marker, contig) buckets of the stored genomes ``names``.
        A streamed store's come from the markers' lengths, so that no
        sketch is read to size them; a placed store's from the stored
        sketches' counts."""
        if streamed:
            by_name = {os.path.basename(m.name): m for m in self._markers}
            markers = [by_name[n] for n in names]
            tl = max((m.total_len for m in markers), default=0)
            return (seed_budget_for(tl, self._params.c),
                    marker_budget_for(tl, self._params.marker_c),
                    max((contig_budget_for(len(m.contig_lengths))
                         for m in markers), default=8))
        return stack_buckets([self._storage.load(n) for n in names],
                             seed_step=8192)

    def _ref_stack(self):
        """(names, stacked DeviceSketch, seed_bucket, marker_bucket) for
        the whole reference store, cached until the next sketch."""
        if self._stack_cache is None:
            names = [os.path.basename(m.name) for m in self._markers]
            bucket, mbucket, cb = self._store_buckets(names, streamed=False)
            stack = stack_sketches([self._storage.load(n) for n in names],
                                   bucket, mbucket, cb)
            self._stack_cache = (names, stack, bucket, mbucket)
        return self._stack_cache

    def query(self, name: str, *contigs: _Sequence, seed: bool = True,
              learned_ani: Optional[bool] = None, median: bool = False,
              robust: bool = False, cutoff: Optional[float] = None,
              faster_small: bool = False, est_ci: bool = False) -> List[Hit]:
        """Query the database with a genome (pyskani lib.rs:512-660).

        ``est_ci=True`` also computes the [5%, 95%] percentile-bootstrap
        interval of the ANI (skani's ``--ci``) into ``Hit.ci_low`` /
        ``Hit.ci_high``."""
        query = self._sketch(name, [_as_bytes(c) for c in contigs], seed)
        cfg = dataclasses.replace(self._chain_cfg, est_ci=True) if est_ci \
            else self._chain_cfg

        hits: List[Hit] = []
        if not self._markers:
            return hits

        # phase 1: batched marker screen (all references at once)
        hi, lo, counts = self._marker_matrix()
        qdev = query.device
        with profiling.scope("screen", self._device):
            passes, _ = screen_batch(
                qdev.markers_hi, qdev.markers_lo, qdev.n_markers,
                hi, lo, counts,
                cutoff if cutoff is not None else SEARCH_ANI_CUTOFF_DEFAULT,
                marker_k=self._params.marker_k, rescue_small=not faster_small)
            passes = passes.cpu().numpy()
        if profiling.enabled():
            profiling.stats().add("refs_screened", len(self._markers))
            profiling.stats().add("screen_passed", int(passes.sum()))
        with profiling.scope("query/shortlist"):
            # shortlist in marker insertion order, deduplicated
            shortlist = list(dict.fromkeys(
                os.path.basename(self._markers[i].name)
                for i in np.nonzero(passes)[0]))

            # phase 2: chain pipelines over the shortlist.  References
            # past the packed range of the block partition's contig bucket
            # (or all of them, for a query >= 2^30 bp) take the full-range
            # per-pair path; results are merged back in shortlist order.
            # Each partition has its own budgets: a giant in one must not
            # inflate the other's fragment budget
            by_name = {os.path.basename(m.name): m for m in self._markers}
            block_names, fb_names, cb, _ = _partition_blockable(
                by_name, shortlist, query.total_len)
            order = {rn: i for i, rn in enumerate(shortlist)}
            block_budgets = self._budgets_for(query, set(block_names)) \
                if block_names else None
            fb_budgets = self._budgets_for(query, set(fb_names)) \
                if fb_names else None
        out: dict = {}

        def merge(part, names_part, budgets):
            with profiling.scope("query/merge"):
                part = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else v for k, v in part.items()}
                check_overflow(part, budgets)
                rows = [order[rn] for rn in names_part]
                for k, arr in part.items():
                    if k not in out:
                        out[k] = np.zeros((len(shortlist),) + arr.shape[1:],
                                          arr.dtype)
                    out[k][rows] = arr

        in_memory = isinstance(self._storage, MemoryStorage)
        if in_memory:
            names_all, stack, bucket, mbucket = self._ref_stack()
        else:
            # a disk store: buckets from the shortlist's markers
            bucket, mbucket, _ = self._store_buckets(shortlist, streamed=True)
        bucket = max(bucket, qdev.seed_budget)
        mbucket = max(mbucket, qdev.marker_budget)
        qpad = repad_sketch(query, bucket, mbucket)
        with profiling.scope("chain", self._device):
            if block_names:
                budgets = block_budgets
                chunk = block_chunk(len(block_names), budgets)
                if in_memory:
                    # the contig axis is cut to the block partition's bucket:
                    # every block-routed genome's contigs fit it
                    stack_block = stack \
                        if cb == stack.contig_lengths.shape[1] else \
                        dataclasses.replace(
                            stack, contig_lengths=stack.contig_lengths[:, :cb])
                    idx = np.array([names_all.index(rn) for rn in block_names],
                                   np.int64)
                    part = one_vs_many(stack_block, qpad, idx, cfg=cfg,
                                       budgets=budgets, chunk=chunk)
                else:
                    # streamed: only the shortlisted sketches, chunk by chunk
                    part = stream_one_vs_many(
                        lambda rn: self._storage.load(rn, device="cpu"),
                        block_names, qpad, cfg=cfg, budgets=budgets,
                        seed_budget=bucket, marker_budget=mbucket,
                        contig_budget=cb, chunk=chunk)
                merge(part, block_names, budgets)
            if fb_names:
                budgets = fb_budgets
                if in_memory:
                    refs = stack
                    idx = np.array([names_all.index(rn) for rn in fb_names],
                                   np.int64)
                else:
                    refs = stack_sketches(
                        [self._storage.load(rn) for rn in fb_names], bucket,
                        mbucket)
                    idx = np.arange(len(fb_names))
                part = one_vs_many_pairs(refs, qpad, idx, cfg=cfg,
                                         budgets=budgets)
                merge(part, fb_names, budgets)
        if profiling.enabled():
            profiling.stats().add("pairs_chained", len(shortlist))

        # the learned correction: one batch over every shortlisted
        # reference, on the Database's device
        corrected = False
        with profiling.scope("query/correct"):
            if shortlist:
                hits, _, corrected = screened_hits(
                    out, [name] * len(shortlist), shortlist, self._params.c,
                    learned_ani, median, robust, self._device)
        if profiling.enabled():
            profiling.stats().add("hits_corrected",
                                  len(shortlist) if corrected else 0)
            profiling.stats().add("correct_batches", int(corrected))
            profiling.stats().add("hits_returned", len(hits))
        return hits

    def save(self, path, overwrite: bool = False,
             format: Optional[str] = None) -> None:
        """Save the database to a folder: ``consolidated`` (default)
        writes sketches.db and index.db, ``separated`` one file per
        sketch; both write markers.bin.  An existing markers.bin raises
        ``FileExistsError`` unless ``overwrite``."""
        folder = _make_folder(path)
        if not overwrite and (folder / "markers.bin").exists():
            raise FileExistsError(str(folder / "markers.bin"))
        out = _disk_storage(folder, format, self._device)
        for marker in self._markers:
            out.store(self._storage.load(os.path.basename(marker.name)),
                      self._params)
        out.flush(self._params, self._markers)

    def flush(self) -> None:
        """Flush the buffers to disk: markers.bin for a folder store, and
        index.db for a consolidated one (nothing for a memory store)."""
        self._storage.flush(self._params, self._markers)
