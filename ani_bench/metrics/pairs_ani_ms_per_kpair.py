"""Milliseconds of the triangle's per-pair path (the program's
``triangle/pairs_ani`` spans: their CUDA timing events on the card) per
1,000 pairs it took (the program's ``pairs_ani_pairs`` counter).  The
span's share of the traced window goes to standard error."""

import sys

SPAN = "triangle/pairs_ani"


def read(w):
    if w.unit != "pairs" or not w.program or w.trace is None \
            or w.trace.busy_s <= 0:
        return None
    sec = w.program.get("timers_s", {}).get(SPAN)
    pairs = w.program.get("counters", {}).get("pairs_ani_pairs")
    if sec is None or not pairs:
        return None
    print(f"ani_bench: {SPAN} {sec:.6g} s of a {w.trace.window_s:.6g} s "
          f"window ({sec / w.trace.window_s:.4f}), {pairs:.0f} pairs",
          file=sys.stderr)
    return sec * 1e3 / (pairs / 1e3)
