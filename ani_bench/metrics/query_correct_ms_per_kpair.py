"""Host milliseconds of ``Database.query``'s correction stage (the
program's ``query/correct`` spans, on the host clock: the learned
correction, the filters and the ``Hit``s) per 1,000 pairs chained in
the window."""


def read(w):
    if w.unit != "pairs" or not w.program or w.units == 0 \
            or w.trace is None or w.trace.busy_s <= 0:
        return None
    sec = w.program.get("timers_s", {}).get("query/correct")
    if sec is None:
        return None
    return sec * 1e3 / (w.units / 1e3)
