"""Entry ``triangle``: one ``engine.batch.triangle`` per call over one
cluster of genomes sketched in set-up, as skani ``triangle`` runs inside
each cluster for dereplication.  The traffic's ``cycle`` lists [cluster
size, clusters per cycle]; each cluster is a subset of one root's
children, chosen by divergence rank (the roots taken by length rank in
turn, so the sizes are the same for every seed), and the cycle's calls
run in a fixed order.

Check: a seeded sample of ``sample`` pairs from completed calls against
the plain reference: identity, aligned fractions and the anchor count of
each pair.  Half the sample comes from a call of the largest cluster,
the other half evenly from one call of each other size; in each call the
pairs are spread evenly over the ``sample_block`` x ``sample_block``
squares of its pair grid, so that every tile of the engine's is sampled
however it tiles.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ani_bench.lib import genomes as gm
from ani_bench.lib import population
from ani_bench.lib.phases import phase
from ani_bench.reference import ani as ref

UNIT = "pairs"
SKETCH_BLOCK = 16          # genomes the reference sketches at once


class Entry:
    unit = UNIT

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = []          # (cluster index, outputs of its pairs)
        self.facts = {"dp_pairs": []}   # (n_anchors, query fragment rows)

    def setup(self) -> None:
        from pyskani_tpu_torch.database import _chain_cfg_for
        from pyskani_tpu_torch.engine.batch import triangle
        from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
        from pyskani_tpu_torch.params import SketchParams
        cfg = self.config
        with phase("genomes made"):
            pop = population.make(cfg["population"], self.seed, self.device)
        self.genomes = pop.children
        params = SketchParams(c=cfg["c"], marker_c=cfg["marker_c"], k=cfg["k"])
        with phase("genomes sketched"):
            self.sketches = sketch_genomes_device(
                [(g.name, g.contigs) for g in self.genomes], params,
                device=self.device)
        self.chain_cfg = _chain_cfg_for(params)
        self._triangle = triangle
        self.rows = np.array([sum(max(1, -(-L // ref.FRAGMENT))
                                  for L in g.lengths())
                              for g in self.genomes])
        # members by divergence rank and the calls' order are the same
        # for every seed; the seed changes the sequences
        rng = population.fixed_rng(3)
        M = int(cfg["population"]["children"])
        by_rank = np.argsort(pop.length_rank)
        clusters = []
        for size, count in self.traffic["cycle"]:
            for _ in range(int(count)):
                root = by_rank[len(clusters) % len(by_rank)]
                ranks = rng.choice(M, int(size), replace=False)
                members = np.sort(pop.div_order[root][ranks])
                clusters.append(root * M + members)
        self.clusters = [clusters[i] for i in rng.permutation(len(clusters))]
        self.period = len(self.clusters)     # calls of one cycle
        self.next = 0
        with phase("warm-up calls"):
            for size in sorted({len(c) for c in self.clusters}):
                first = next(c for c in self.clusters if len(c) == size)
                self._run(first)

    def _run(self, members):
        ri, qi, out = self._triangle([self.sketches[m] for m in members],
                                     cfg=self.chain_cfg)
        return ri, qi, out

    def next_units(self) -> int:
        n = len(self.clusters[self.next % len(self.clusters)])
        return n * (n - 1) // 2

    def call(self) -> None:
        c = self.next % len(self.clusters)
        self.next += 1
        members = self.clusters[c]
        ri, qi, out = self._run(members)
        keep = {k: np.asarray(out[k]) for k in
                ("ani_mean", "af_query", "af_ref", "n_anchors")}
        self.log.append((c, keep))
        self.facts["dp_pairs"].extend(zip(
            keep["n_anchors"].tolist(), self.rows[members[qi]].tolist()))

    def release(self) -> None:
        self.sketches = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """(cluster, pair index) items of the completed calls."""
        if not self.log:
            return []
        rng = gm.host_rng(self.seed, 8)
        done = sorted({c for c, _ in self.log})
        sizes = sorted({len(self.clusters[c]) for c in done})
        k = int(self.traffic["sample"])
        blk = int(self.traffic["sample_block"])
        share = {s: (k - k // 2) // max(1, len(sizes) - 1)
                 for s in sizes[:-1]}
        share[sizes[-1]] = k // 2 if len(sizes) > 1 else k
        items = []
        for size, want in share.items():
            c = int(rng.choice([c for c in done
                                if len(self.clusters[c]) == size]))
            ri, qi = np.triu_indices(size, k=1)
            square = (ri // blk) * size + qi // blk
            ids = rng.permutation(np.unique(square))
            per, extra = divmod(want, len(ids))
            for j, sq in enumerate(ids):
                idx = np.nonzero(square == sq)[0]
                m = min(len(idx), per + (j < extra))
                items += [(c, int(p)) for p in
                          rng.choice(idx, m, replace=False)]
        return sorted(items)

    def _reference(self, precision: str) -> dict:
        if not hasattr(self, "_items"):
            self._items = self._sample()
            members = {}
            for c, p in self._items:
                ri, qi = np.triu_indices(len(self.clusters[c]), k=1)
                members[(c, p)] = (int(self.clusters[c][ri[p]]),
                                   int(self.clusters[c][qi[p]]))
            need = sorted({g for pair in members.values() for g in pair})
            self._sk = {}
            with phase(f"reference sketch of {len(need)} genomes"):
                for lo in range(0, len(need), SKETCH_BLOCK):
                    part = need[lo:lo + SKETCH_BLOCK]
                    self._sk.update(zip(part, ref.sketch_many(
                        [self.genomes[g].contigs for g in part],
                        self.device)))
            self._members = members
        with phase(f"reference chain of {len(self._items)} pairs "
                   f"({precision})"):
            res = ref.chain_pairs([(self._sk[r], self._sk[q]) for r, q in
                                   (self._members[i] for i in self._items)],
                                  k=self.config["k"], precision=precision)
        return dict(zip(self._items, res))

    def check(self, control: bool = False) -> dict:
        want = self._reference("f64")
        got = []
        if control:
            got = list(self._reference("bf16").items())
        else:
            for c, out in self.log:
                for (c2, p) in self._items:
                    if c2 == c:
                        got.append(((c, p), {
                            "ani": float(out["ani_mean"][p]),
                            "af_query": float(out["af_query"][p]),
                            "af_ref": float(out["af_ref"][p]),
                            "n_anchors": int(out["n_anchors"][p])}))
        if not got:
            raise RuntimeError("no completed call of a sampled pair")
        gaps = {"ani_gap": 0.0, "af_gap": 0.0, "anchors_gap": 0}
        for key, o in got:
            w = want[key]
            gaps["ani_gap"] = max(gaps["ani_gap"], abs(o["ani"] - w["ani"]))
            gaps["af_gap"] = max(gaps["af_gap"],
                                 abs(o["af_query"] - w["af_query"]),
                                 abs(o["af_ref"] - w["af_ref"]))
            gaps["anchors_gap"] = max(gaps["anchors_gap"],
                                      abs(o["n_anchors"] - w["n_anchors"]))
        return gaps
