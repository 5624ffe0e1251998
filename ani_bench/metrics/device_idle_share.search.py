"""Share of the traced search window in which no operation ran on the
device: 1 - (union of the device's activity intervals / window)."""


def read(w):
    if w.unit != "pairs" or "hits" not in w.facts or w.trace is None \
            or w.trace.window_s <= 0:
        return None
    return 1.0 - w.trace.busy_s / w.trace.window_s
