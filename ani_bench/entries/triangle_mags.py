"""Entry ``triangle_mags``: one ``engine.batch.triangle`` per call over
one cluster of a MAG dereplication pool (``lib/drafts.py``) sketched in
set-up, as galah and dRep run skani ``triangle`` over the MAGs of many
samples together with a species' complete genomes.

The traffic's ``cycle`` lists [cluster size, clusters per cycle].  Each
cluster holds members of one species (the species taken by length rank
in turn): a quarter complete genomes, the rest drafts, among them at
least one draft of more than ``wide_draft`` contigs, whose contig table
puts every complete genome of the call past the packed range, so that
their pairs take ``pairs_ani``.  Members, by (length rank, divergence
rank), and the calls' order are the same for every seed.

Check: a seeded sample of ``sample`` pairs from completed calls against
the plain reference, as the ``triangle`` entry checks: half of it from
pairs that touch a complete genome (complete x draft, complete x
complete), half from draft x draft pairs, each half spread over the
cluster sizes and the completed calls as the ``triangle_small`` entry
spreads its sample.
"""

from __future__ import annotations

import numpy as np

from ani_bench.entries import triangle_small
from ani_bench.lib import drafts
from ani_bench.lib import genomes as gm
from ani_bench.lib import population
from ani_bench.lib.phases import phase
from ani_bench.reference import ani as ref


class Entry(triangle_small.Entry):

    def setup(self) -> None:
        from pyskani_tpu_torch.database import _chain_cfg_for
        from pyskani_tpu_torch.engine.batch import triangle as run
        from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
        from pyskani_tpu_torch.params import SketchParams
        cfg = self.config
        with phase("genomes made"):
            pool = drafts.make(cfg["population"], cfg["drafts"], self.seed,
                               self.device)
        self.genomes = pool.genomes
        self.complete = pool.complete
        params = SketchParams(c=cfg["c"], marker_c=cfg["marker_c"], k=cfg["k"])
        with phase("genomes sketched"):
            self.sketches = sketch_genomes_device(
                [(g.name, g.contigs) for g in self.genomes], params,
                device=self.device)
        self.chain_cfg = _chain_cfg_for(params)
        self._triangle = run
        self.rows = np.array([sum(max(1, -(-L // ref.FRAGMENT))
                                  for L in g.lengths())
                              for g in self.genomes])
        self.clusters = clusters(pool, self.traffic)
        self.period = len(self.clusters)
        self.next = 0
        with phase("warm-up calls"):
            for size in sorted({len(c) for c in self.clusters}):
                self._run(next(c for c in self.clusters if len(c) == size))

    def _sample(self):
        """(cluster, pair index) items of the completed calls."""
        if not self.log:
            return []
        rng = gm.host_rng(self.seed, 8)
        done = sorted({c for c, _ in self.log})
        k = int(self.traffic["sample"])
        return sorted(
            self._by_size(rng, done, k // 2, self._touches)
            + self._by_size(rng, done, k - k // 2,
                            lambda c: ~self._touches(c)))

    def _touches(self, c: int) -> np.ndarray:
        """[pairs] whether each pair of cluster ``c`` (triu order) holds a
        complete genome."""
        members = self.clusters[c]
        ri, qi = np.triu_indices(len(members), k=1)
        return self.complete[members[ri]] | self.complete[members[qi]]


def clusters(pool: drafts.Pool, traffic: dict) -> list:
    """The cycle's clusters in call order: arrays of member indices, each
    in divergence-rank order."""
    M = pool.div_order.shape[1]
    rng = population.fixed_rng(3)
    wide = int(traffic["wide_draft"])
    by_rank = np.argsort(pool.length_rank)
    n_contigs = pool.n_contigs
    out = []
    for size, count in traffic["cycle"]:
        for _ in range(int(count)):
            root = by_rank[len(out) % len(by_rank)]
            members = root * M + pool.div_order[root]   # by divergence rank
            whole = np.nonzero(pool.complete[members])[0]
            part = np.nonzero(~pool.complete[members])[0]
            n_whole = int(size) // 4
            pick = np.concatenate([
                rng.choice(whole, n_whole, replace=False),
                rng.choice(part, int(size) - n_whole, replace=False)])
            if not (n_contigs[members[pick]] > wide).any():
                # the first draft of the pick gives way to a wide one
                pick[n_whole] = rng.choice(
                    part[n_contigs[members[part]] > wide])
            out.append(members[np.sort(pick)])
    return [out[i] for i in rng.permutation(len(out))]
