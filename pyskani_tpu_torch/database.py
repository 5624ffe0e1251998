"""Database: the pyskani-compatible user API over the PyTorch engine.

Port of the JAX package's ``database.py``: the same constructor
defaults, storage formats, exceptions and context-manager semantics;
``sketch``, ``sketch_many`` (batched sketching of many genomes) and
``query`` (batched marker screen, then the chain pipelines over the
shortlist, then the regression and aligned-fraction filters, then
``Hit``, with the bootstrap interval under ``est_ci=True``).
Shortlisted references chain on the packed block pipeline
(``chain_block``) unless a contig of theirs lies past its position range,
or the query is 2^30 bp or more: those pairs take the full-range per-pair
pipeline (``chain_pairs``).  Genomes above the single-call sketch buffer
are sketched in chunks.

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

from . import regression
from .db.storage import (ConsolidatedStorage, FolderStorage, MarkerSketch,
                         MemoryStorage, load_index, load_markers)
from .engine.batch import (check_overflow, one_vs_many, one_vs_many_pairs,
                           repad_sketch, stack_sketches)
from .engine.stream import stream_one_vs_many
from .hit import Hit
from .ops.chain import ChainConfig, EngineBudgets, rcid_bits_for
from .ops.screen import screen_batch
from .ops.sketch import (HostSketch, contig_budget_for, marker_budget_for,
                         round_up, seed_budget_for, sketch_genome_device,
                         sketch_genomes_device)
from .params import (MIN_ANI_KEEP, CommandParams, SEARCH_ANI_CUTOFF_DEFAULT,
                     SketchParams)
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
    ``2^(32-rcid_bits)``; ``fb_names`` exceed the cap and need the
    full-range per-pair pipeline.  Iterated to a fixed point.  Queries
    >= 2^30 bp total route every reference to the full-range path."""
    if query_total >= (1 << 30):
        return [], list(shortlist), 8, 1 << (32 - rcid_bits_for(8))
    block = list(shortlist)
    while True:
        cb = max((contig_budget_for(len(by_name[rn].contig_lengths))
                  for rn in block), default=8)
        cap = 1 << (32 - rcid_bits_for(cb))
        viol = {rn for rn in block
                if max(by_name[rn].contig_lengths, default=0) >= cap}
        if not viol:
            break
        block = [rn for rn in block if rn not in viol]
    blocked = set(block)
    return block, [rn for rn in shortlist if rn not in blocked], cb, cap


def _pow2_chunk(n: int, cap: int = 16) -> int:
    """Bucket a chunk size to a power of two."""
    p = 1
    while p < min(max(n, 1), cap):
        p *= 2
    return p


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
        self._device = _resolve_device(device)
        self._params = SketchParams(c=compression,
                                    marker_c=marker_compression, k=k)
        self._markers: List[MarkerSketch] = []
        self._chain_cfg = _chain_cfg_for(self._params)
        self._screen_cache = None
        self._stack_cache = None
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
        params, markers = load_markers(markers_path)
        self = cls.__new__(cls)
        self._device = _resolve_device(device)
        self._params = params
        self._markers = markers
        self._chain_cfg = _chain_cfg_for(params)
        self._screen_cache = None
        self._stack_cache = None
        if (folder / "index.db").exists() and \
                (folder / "sketches.db").exists():
            self._storage = ConsolidatedStorage(folder, load_index(folder),
                                                device=self._device)
        else:
            self._storage = FolderStorage(folder, device=self._device)
        return self

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
        self._sketch(name, [_as_bytes(c) for c in contigs], seed)

    def _sketch(self, name: str, data, seed: bool = True) -> Sketch:
        with profiling.scope("sketch", self._device):
            host = sketch_genome_device(name, data, self._params, seed=seed,
                                        device=self._device)
        if profiling.enabled():
            profiling.stats().add("bases_sketched", sum(map(len, data)))
        self._register_sketch(host)
        return Sketch(host, self._params.c)

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
        # the longest shortlisted reference, bucketed to limit shapes
        nf_q = query.n_fragments(fl)
        markers = self._markers if shortlist is None else \
            [m for m in self._markers
             if os.path.basename(m.name) in shortlist]
        nf_r = max((sum(max(1, -(-L // fl)) for L in m.contig_lengths)
                    for m in markers), default=1)
        nf = round_up(max(nf_q, nf_r) + 2, 128)
        if nf > 384:
            p = 512
            while p < nf:
                p *= 2
            nf = p
        qa = query.device.seed_budget
        return EngineBudgets(
            max_anchors=round_up(int(qa * 1.5) + 4096, 8192),
            max_fragments=nf,
            max_anchors_per_fragment=256,
        )

    def _ref_stack(self):
        """(names, stacked DeviceSketch, seed_bucket, marker_bucket) for
        the whole reference store, cached until the next sketch."""
        if self._stack_cache is None:
            names = [os.path.basename(m.name) for m in self._markers]
            refs = [self._storage.load(n) for n in names]
            counts = torch.stack([torch.stack([r.device.n_seeds,
                                               r.device.n_markers])
                                  for r in refs]).cpu()
            bucket = round_up(int(counts[:, 0].max()), 8192)
            mbucket = round_up(int(counts[:, 1].max()), 512)
            stack = stack_sketches(refs, seed_budget=bucket,
                                   marker_budget=mbucket)
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
        data = [_as_bytes(c) for c in contigs]
        with profiling.scope("sketch", self._device):
            query = sketch_genome_device(name, data, self._params,
                                         seed=seed, device=self._device)
        if profiling.enabled():
            profiling.stats().add("bases_sketched", sum(map(len, data)))
        learned = learned_ani if learned_ani is not None else \
            regression.use_learned_ani(self._params.c, False, False, median)
        cmd = CommandParams(
            screen_val=(cutoff if cutoff is not None
                        else SEARCH_ANI_CUTOFF_DEFAULT),
            robust=robust, median=median, learned_ani=learned,
            rescue_small=not faster_small, est_ci=est_ci)
        model = regression.get_model(self._params.c, cmd.learned_ani)
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
                hi, lo, counts, cmd.screen_val,
                marker_k=self._params.marker_k,
                rescue_small=cmd.rescue_small)
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
            qpad = repad_sketch(query, max(bucket, qdev.seed_budget),
                                max(mbucket, qdev.marker_budget))
        else:
            # a disk store: budgets from the shortlist's lengths
            tl = max((by_name[rn].total_len for rn in shortlist), default=0)
            bucket = max(seed_budget_for(tl, self._params.c),
                         qdev.seed_budget)
            mbucket = max(marker_budget_for(tl, self._params.marker_c),
                          qdev.marker_budget)
            qpad = repad_sketch(query, bucket, mbucket)
        with profiling.scope("chain", self._device):
            if block_names:
                budgets = block_budgets
                bcap = max(1, min(16, (1 << 17) // budgets.max_fragments))
                chunk = _pow2_chunk(len(block_names), cap=bcap)
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
                                         budgets=budgets,
                                         chunk=_pow2_chunk(len(idx), cap=4))
                merge(part, fb_names, budgets)
        if profiling.enabled():
            profiling.stats().add("pairs_chained", len(shortlist))

        key = "ani_median" if median else \
            "ani_robust" if robust else "ani_mean"
        maf = cmd.min_aligned_frac

        def clamp(v) -> float:
            return min(max(float(v), 0.0), 1.0)

        # the learned correction targets the MEAN estimator only: one
        # batch over every hit, on the Database's device
        corrected = bool(shortlist) and model is not None and not median \
            and not robust
        with profiling.scope("query/correct"):
            if shortlist:
                af_q = out["af_query"].astype(np.float64)
                af_r = out["af_ref"].astype(np.float64)
                ani = out[key].astype(np.float64)
                if corrected:
                    ani = regression.apply_model_batch(model, ani, af_q, af_r,
                                                       self._device)
                keep = ~((af_q < maf) & (af_r < maf)) & (ani > MIN_ANI_KEEP)
                for i in np.nonzero(keep)[0]:
                    ci = dict(ci_low=clamp(out["ani_ci_low"][i]),
                              ci_high=clamp(out["ani_ci_high"][i])) \
                        if est_ci else {}
                    hits.append(Hit(clamp(ani[i]), name, float(af_q[i]),
                                    shortlist[i], float(af_r[i]), **ci))
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
