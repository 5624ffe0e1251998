"""Entry ``search``: one ``Database.query`` per call, of a held-out
member of one species against an in-memory store of the others, as a lab
places a new isolate among its collection of the species with skani
``search`` (pyskani ``Database.query``, at its defaults).

Set-up: the configuration's population (``roots`` species of
``children`` members).  In each species ``queries_per_species`` members
at evenly spaced divergence ranks are held out as queries; the other
``store_per_species`` are sketched into one ``Database`` by
``sketch_many``, species after species, each species' members in their
own order.  Then one warm-up query, without the learned correction: it
runs every shape the window's queries run on the card (the query's
sketch, the screen, the stacked store, the chain blocks), and the
correction is host NumPy that warms nothing.  A cycle is one call of
each species in turn; each cycle moves on to every species' next
held-out member, so the queries repeat every ``queries_per_species``
cycles.  A call's units are the pairs it chains: the query's
conspecific stored genomes, which the configuration gives.

Check, against the plain reference (``reference/search.py``): a seeded
sample of ``sample_per_species`` stored genomes of every species, spread
evenly over the ``sample_block`` slots of a chain block (a stored
genome's index in its species, modulo the block), is searched by every
query of the window.  ``hits_differ`` counts the (call, sampled genome)
pairs where the program's hits and the reference's screen and filter
disagree; ``ani_gap`` and ``af_gap`` are the largest differences over
the sampled genomes that both call hits, which are every query's
sampled conspecifics: at least 4 queries x ``sample_per_species`` hits,
over every slot.  ``hits_count_gap`` holds every call, and not only the
sample, to the pairs the rate credits it with: the sum over the calls of
|hits returned - ``store_per_species``|.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ani_bench.lib import genomes as gm
from ani_bench.lib import population
from ani_bench.lib.phases import phase
from ani_bench.reference import ani as ref
from ani_bench.reference import search as ref_search

UNIT = "pairs"
SKETCH_BLOCK = 16          # genomes the reference sketches at once


class Entry:
    unit = UNIT

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = []          # (query index, {sampled name: outputs})
        self.counts = []       # hits returned by each call
        self.facts = {"hits": 0}

    def setup(self) -> None:
        import pyskani_tpu_torch
        cfg = self.config
        pop_cfg = cfg["population"]
        S = int(cfg["store_per_species"])
        Q = int(cfg["queries_per_species"])
        M = int(pop_cfg["children"])
        if S + Q != M:
            raise ValueError("children must be store_per_species + "
                             "queries_per_species")
        with phase("genomes made"):
            pop = population.make(pop_cfg, self.seed, self.device)
        # held out: evenly spaced divergence ranks, the same every seed
        ranks = ((np.arange(Q) + 0.5) * M / Q).astype(np.int64)
        self.queries, stored = [], []
        for r in range(len(pop.length_rank)):
            held = set(pop.div_order[r][ranks].tolist())
            self.queries.append([pop.children[r * M + c] for c in sorted(held)])
            stored.append([pop.children[r * M + c] for c in range(M)
                           if c not in held])
        self.n_species = len(stored)
        self.period = self.n_species
        self.sample = self._sample(stored)
        self.sample_names = {g.name for g, _, _ in self.sample}
        del pop
        self.db = pyskani_tpu_torch.Database(
            device=self.device, compression=cfg["c"],
            marker_compression=cfg["marker_c"], k=cfg["k"])
        with phase(f"store of {sum(map(len, stored))} genomes sketched"):
            self.db.sketch_many((g.name, g.contigs)
                                for species in stored for g in species)
        del stored
        self.next = 0
        with phase("warm-up query"):
            g = self.queries[0][0]
            self.db.query(g.name, *g.contigs, learned_ani=False)

    def _sample(self, stored):
        """(genome, species, slot) of the seeded sample of every
        species' stored genomes, spread evenly over the slots."""
        rng = gm.host_rng(self.seed, 8)
        want = int(self.traffic["sample_per_species"])
        blk = int(self.traffic["sample_block"])
        out = []
        for sp, members in enumerate(stored):
            slots = np.arange(len(members)) % blk
            per = -(-want // blk)
            picked = []
            for s in range(blk):
                idx = np.nonzero(slots == s)[0]
                picked += rng.choice(idx, min(per, len(idx)),
                                     replace=False).tolist()
            picked = sorted(rng.permutation(picked)[:want].tolist())
            out += [(members[j], sp, j % blk) for j in picked]
        return out

    def _which(self, n: int):
        """(species, held-out index) of the n-th call."""
        return n % self.n_species, (n // self.n_species) % \
            len(self.queries[0])

    def next_units(self) -> int:
        return int(self.config["store_per_species"])

    def call(self) -> None:
        sp, j = self._which(self.next)
        self.next += 1
        g = self.queries[sp][j]
        hits = self.db.query(g.name, *g.contigs)
        self.facts["hits"] += len(hits)
        self.counts.append(len(hits))
        self.log.append(((sp, j), {
            h.reference_name: (h.identity, h.query_fraction,
                               h.reference_fraction)
            for h in hits if h.reference_name in self.sample_names}))

    def release(self) -> None:
        self.db = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str) -> dict:
        """{query key: {sampled name: reference outputs}}, the window's
        queries searched against the sample."""
        c = self.config
        if not hasattr(self, "_sk"):
            keys = sorted({key for key, _ in self.log})
            genomes = [g for g, _, _ in self.sample] + \
                [self.queries[sp][j] for sp, j in keys]
            sk = []
            with phase(f"reference sketch of {len(genomes)} genomes"):
                for lo in range(0, len(genomes), SKETCH_BLOCK):
                    sk += ref.sketch_many(
                        [g.contigs for g in genomes[lo:lo + SKETCH_BLOCK]],
                        self.device, k=c["k"], c=c["c"],
                        marker_k=c["marker_k"], marker_c=c["marker_c"])
            n = len(self.sample)
            self._stored_sk = sk[:n]
            self._sk = dict(zip(keys, sk[n:]))
            self._model = ref_search.load_model()
        out = {}
        names = [g.name for g, _, _ in self.sample]
        with phase(f"reference search of {len(self._sk)} queries "
                   f"({precision})"):
            for key, qsk in self._sk.items():
                res = ref_search.search(qsk, self._stored_sk, self._model,
                                        k=c["k"], marker_k=c["marker_k"],
                                        precision=precision)
                out[key] = dict(zip(names, res))
        return out

    def check(self, control: bool = False) -> dict:
        if not self.log:
            raise RuntimeError("no completed call")
        want = self._reference("f64")
        if control:
            low = self._reference("bf16")
            got = [(key, {n: (r["ani"], r["af_query"], r["af_ref"])
                          for n, r in low[key].items() if r["hit"]})
                   for key, _ in self.log]
        else:
            got = self.log
        S = int(self.config["store_per_species"])
        gaps = {"hits_differ": 0, "ani_gap": 0.0, "af_gap": 0.0,
                "hits_count_gap": sum(abs(n - S) for n in self.counts)}
        for key, hits in got:
            for name, w in want[key].items():
                o = hits.get(name)
                if (o is not None) != w["hit"]:
                    gaps["hits_differ"] += 1
                    continue
                if o is None:
                    continue
                gaps["ani_gap"] = max(gaps["ani_gap"], abs(o[0] - w["ani"]))
                gaps["af_gap"] = max(gaps["af_gap"],
                                     abs(o[1] - w["af_query"]),
                                     abs(o[2] - w["af_ref"]))
        return gaps
