"""Entry ``sketch_many``: one ``Database.sketch_many`` of the traffic's
pool into a fresh ``Database`` per call, as a genome set is sketched
before its triangle or a store is built.  The pool is a population of
the configuration's kind with ``roots`` of its own.

Check: for a seeded sample of the pool's genomes, the seed table (k-mer,
position, contig, strand, in table order) and the marker set that every
call stored, against the plain reference's sketch of the same bytes.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ani_bench.lib import genomes as gm
from ani_bench.lib import population
from ani_bench.lib.phases import phase
from ani_bench.reference import ani as ref

UNIT = "genomes"


class Entry:
    unit = UNIT

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = []             # {pool index: stored tables} per call
        self.facts = {"bases": 0}

    def setup(self) -> None:
        import pyskani_tpu_torch
        self._db = pyskani_tpu_torch.Database
        with phase("genomes made"):
            pop = population.make(self.config["population"], self.seed,
                                  self.device, roots=self.traffic["roots"])
        self.pool = pop.children
        self.items = [(g.name, g.contigs) for g in self.pool]
        self.bases = sum(g.length for g in self.pool)
        rng = gm.host_rng(self.seed, 8)
        k = min(len(self.pool), int(self.traffic["sample"]))
        self.sample = sorted(rng.choice(len(self.pool), k, replace=False)
                             .tolist())
        with phase("warm-up call"):
            self._new().sketch_many(self.items)

    def _new(self):
        c = self.config
        return self._db(device=self.device, compression=c["c"],
                        marker_compression=c["marker_c"], k=c["k"])

    def next_units(self) -> int:
        return len(self.pool)

    def call(self) -> None:
        db = self._new()
        db.sketch_many(self.items)
        # the sampled genomes' stored tables, copied out so that they do
        # not hold the call's whole store on the device
        self.log.append({i: _table(db._storage.load(self.pool[i].name))
                         for i in self.sample})
        self.facts["bases"] += self.bases

    def release(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        c = self.config
        want = ref.sketch_many([self.pool[i].contigs for i in self.sample],
                               self.device, k=c["k"], c=c["c"],
                               marker_k=c["marker_k"],
                               marker_c=c["marker_c"])
        want = {i: _ref_table(s) for i, s in zip(self.sample, want)}
        if control:
            low = ref.sketch_many([self.pool[i].contigs for i in self.sample],
                                  self.device, k=c["k"], c=c["c"],
                                  marker_k=c["marker_k"],
                                  marker_c=c["marker_c"], bits32=True)
            got = [{i: _ref_table(s) for i, s in zip(self.sample, low)}]
        else:
            got = self.log
        if not got:
            raise RuntimeError("no completed call")
        seeds = markers = 0
        for stored in got:
            for i, (tab, mk) in stored.items():
                wtab, wmk = want[i]
                seeds += _rows_differ(tab, wtab)
                markers += _rows_differ(mk, wmk)
        return {"seed_rows_differ": seeds, "marker_rows_differ": markers}


def _table(host):
    dev = host.device
    n, m = int(dev.n_seeds), int(dev.n_markers)
    tab = torch.stack([dev.kmers[:n], dev.positions[:n].long(),
                       dev.contig_ids[:n].long(), dev.strands[:n].long()], 1)
    mk = (dev.markers_hi[:m] << 32) | dev.markers_lo[:m]
    return tab, mk


def _ref_table(s: ref.RefSketch):
    tab = np.stack([s.kmers, s.positions, s.contig_ids,
                    s.strands.astype(np.int64)], 1)
    return torch.from_numpy(tab), torch.from_numpy(s.markers)


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows that differ between two tables, a missing row counting."""
    a, b = a.cpu(), b.cpu()
    n = min(len(a), len(b))
    same = (a[:n] == b[:n])
    if same.dim() > 1:
        same = same.all(1)
    return int((~same).sum()) + abs(len(a) - len(b))
