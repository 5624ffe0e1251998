"""Share of the window's pairs that the triangle sent down its per-pair
path (the program's ``pairs_ani_pairs`` counter over the pairs of every
completed call), read where the program counts its chain calls
(``chain_calls``), so that a program without the routing counters reads
nothing rather than 0."""


def read(w):
    if w.unit != "pairs" or not w.program or w.units == 0:
        return None
    counters = w.program.get("counters", {})
    if "chain_calls" not in counters:
        return None
    return counters.get("pairs_ani_pairs", 0.0) / w.units
