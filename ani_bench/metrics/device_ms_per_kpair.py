"""Device busy milliseconds in the traced window per 1,000 pairs."""


def read(w):
    if w.unit != "pairs" or w.trace is None or w.units == 0:
        return None
    return w.trace.busy_s * 1e3 / (w.units / 1e3)
