"""Calls of the chain pipelines (``chain_triangle``, ``chain_block`` and
``chain_pairs``: the program's ``chain_calls`` counter) per 1,000 pairs
of the window."""


def read(w):
    if w.unit != "pairs" or not w.program or w.units == 0:
        return None
    calls = w.program.get("counters", {}).get("chain_calls")
    if calls is None:
        return None
    return calls / (w.units / 1e3)
