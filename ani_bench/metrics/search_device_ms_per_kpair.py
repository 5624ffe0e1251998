"""Device busy milliseconds in the traced search window per 1,000 pairs
chained (a query's pairs are its conspecific stored genomes)."""


def read(w):
    if w.unit != "pairs" or "hits" not in w.facts or w.trace is None \
            or w.units == 0:
        return None
    return w.trace.busy_s * 1e3 / (w.units / 1e3)
