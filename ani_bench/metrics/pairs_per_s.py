"""Genome pairs of every triangle call completed in the window, over the
time to the last completion."""

from ani_bench.lib.stats import rate


def read(w):
    if w.unit != "pairs":
        return None
    return rate(w.units, w.start, w.end)
