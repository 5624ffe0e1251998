"""Milliseconds of the marker screen (the program's ``screen`` spans:
its CUDA timing events on the card, from the query's markers to the
pass vector read back) per query of the window."""


def read(w):
    if w.unit != "pairs" or "hits" not in w.facts or not w.program \
            or not w.calls or w.trace is None or w.trace.busy_s <= 0:
        return None
    sec = w.program.get("timers_s", {}).get("screen")
    if sec is None:
        return None
    return sec * 1e3 / len(w.calls)
