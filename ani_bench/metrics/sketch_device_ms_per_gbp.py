"""Device busy milliseconds in the traced window per Gbp sketched."""


def read(w):
    if w.trace is None or not w.facts.get("bases"):
        return None
    return w.trace.busy_s * 1e3 / (w.facts["bases"] / 1e9)
