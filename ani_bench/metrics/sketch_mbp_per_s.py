"""Bases of every genome sketched in the window, in Mbp, over the time
to the last completion."""

from ani_bench.lib.stats import rate


def read(w):
    if "bases" not in w.facts:
        return None
    return rate(w.facts["bases"] / 1e6, w.start, w.end)
