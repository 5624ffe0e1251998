"""Milliseconds the chain join (the program's ``chain/join`` spans: the
seed sort, run expansion and pool counts) held the device's stream, per
1,000 pairs: the span's CUDA timing events, summed over the window."""

from ani_bench.lib.spans import span_device_ms_per_kpair


def read(w):
    return span_device_ms_per_kpair(w, "chain/join")
