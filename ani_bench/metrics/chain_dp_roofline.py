"""Share (%) of its roofline that the chain-DP kernel reaches: the least
time the card could take for the DP the window's pairs need
(``lib/roofline.py``: bytes and operations from each pair's anchors),
over the device time of every ``chain_dp_kernel`` launch in the trace."""

import sys

from ani_bench.lib.roofline import least_time

KERNEL = "chain_dp_kernel"


def read(w):
    pairs = w.facts.get("dp_pairs")
    if w.trace is None or not pairs:
        return None
    measured = sum(s for name, s in w.trace.by_name.items() if KERNEL in name)
    if measured <= 0:
        return None
    seconds, bound = least_time(pairs)
    print(f"ani_bench: chain_dp_roofline {seconds:.6g} s least time, bound "
          f"by {bound}, over {measured:.6g} s measured", file=sys.stderr)
    return 100.0 * seconds / measured
