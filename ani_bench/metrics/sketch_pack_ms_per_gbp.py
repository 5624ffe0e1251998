"""Host milliseconds of packing the bases into ``[B, L]`` byte stacks
(the program's ``sketch/pack`` spans, on the host clock) per Gbp
sketched in the window."""


def read(w):
    if w.unit != "genomes" or not w.program or not w.facts.get("bases") \
            or w.trace is None or w.trace.busy_s <= 0:
        return None
    sec = w.program.get("timers_s", {}).get("sketch/pack")
    if sec is None:
        return None
    return sec * 1e3 / (w.facts["bases"] / 1e9)
