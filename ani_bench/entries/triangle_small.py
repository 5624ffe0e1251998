"""Entry ``triangle_small``: the ``triangle`` entry, with a check that
reaches every call of the cycle.  Its traffic holds many calls of each
size (32 clusters of 2, 16 of 4, ...), and a fault that depends on the
call, such as state carried from one small call to the next or the
padding of a group of 2, shows in one call and not in the others.

Check: a seeded sample of ``sample`` pairs from completed calls against
the plain reference: the sample is spread evenly over the cluster sizes
(a size's share left unused passes to the larger sizes), and a size's
share is dealt evenly over every completed call of that size, each
call's pairs drawn at random.
"""

from __future__ import annotations

import numpy as np

from ani_bench.entries import triangle
from ani_bench.lib import genomes as gm


def spread(rng, pairs_of: dict, quota: int) -> list:
    """Up to ``quota`` (call, pair index) items dealt in turn over the
    calls of ``pairs_of`` ({call: pair indices}), in a random order of
    calls, each call's pairs drawn at random without replacement."""
    decks = {c: list(rng.permutation(np.asarray(p, dtype=np.int64)))
             for c, p in pairs_of.items()}
    order = [c for c in rng.permutation(sorted(decks)) if decks[c]]
    items = []
    while order and len(items) < quota:
        for c in list(order):
            if len(items) == quota:
                break
            items.append((int(c), int(decks[c].pop())))
            if not decks[c]:
                order.remove(c)
    return items


class Entry(triangle.Entry):

    def _sample(self):
        """(cluster, pair index) items of the completed calls."""
        if not self.log:
            return []
        rng = gm.host_rng(self.seed, 8)
        done = sorted({c for c, _ in self.log})
        k = int(self.traffic["sample"])
        return sorted(self._by_size(rng, done, k, lambda c: None))

    def _by_size(self, rng, done, quota: int, pick) -> list:
        """``quota`` items spread evenly over the sizes of the ``done``
        calls, each size's share by ``spread``; ``pick(c)`` is a mask of
        call ``c``'s pairs to draw from, or None for all of them."""
        sizes = sorted({len(self.clusters[c]) for c in done})
        items = []
        for j, size in enumerate(sizes):
            pairs_of = {}
            for c in done:
                if len(self.clusters[c]) == size:
                    mask = pick(c)
                    pairs_of[c] = (np.arange(size * (size - 1) // 2)
                                   if mask is None else np.nonzero(mask)[0])
            got = spread(rng, pairs_of, quota // (len(sizes) - j))
            items += got
            quota -= len(got)
        return items
