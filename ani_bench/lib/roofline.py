"""The yardstick of a kernel's share of its roofline: the card's peaks
and the bytes and operations that the chain DP's inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores.  The chain DP is integer and float32 work on the CUDA cores.

The DP needs, per anchor, its three int32 inputs read once and an f32
score and an int32 root written once (20 bytes), and a test of each
predecessor in its band: ``min(j, BAND)`` tests of 20 operations for
the anchor at column j of its fragment row.  Anchors are counted from
what the pairs need (each pair's ``n_anchors``), never from a padded
grid, so a kernel that pads less cannot move the yardstick.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
BYTES_PER_ANCHOR = 20
OPS_PER_TEST = 20
BAND = 25


def tests_in_row(count: float) -> float:
    """Predecessor tests of a row of ``count`` anchors, sum over j <
    count of min(j, BAND), linear between whole counts (so convex)."""
    c = int(math.floor(count))
    whole = c * (c - 1) / 2 if c <= BAND + 1 else 25 * c - 325
    return whole + (count - c) * min(c, BAND)


def pair_tests(anchors: int, rows: int) -> float:
    """Least predecessor tests of a pair whose ``anchors`` lie in at
    most ``rows`` fragment rows: the rows equally full (the count per
    row is convex, so any other split needs more)."""
    if anchors <= 0:
        return 0.0
    return rows * tests_in_row(anchors / rows)


def least_time(pairs: Iterable[Tuple[int, int]]) -> Tuple[float, str]:
    """(seconds, bound) for pairs of (n_anchors, query fragment rows):
    the larger of bytes over peak bandwidth and operations over peak
    rate, and which of the two it is."""
    anchors = 0
    tests = 0.0
    for a, rows in pairs:
        anchors += a
        tests += pair_tests(a, rows)
    by_bytes = anchors * BYTES_PER_ANCHOR / PEAK_BYTES_PER_S
    by_ops = tests * OPS_PER_TEST / PEAK_FLOPS
    return (by_ops, "operations") if by_ops > by_bytes else \
        (by_bytes, "bytes")
