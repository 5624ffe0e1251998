"""Milliseconds the post-DP statistics (the program's ``chain/post``
spans: ``index_add_``, the scatter-reduces, the estimators) held the
device's stream, per 1,000 pairs: the span's CUDA timing events, summed
over the window."""

from ani_bench.lib.spans import span_device_ms_per_kpair


def read(w):
    return span_device_ms_per_kpair(w, "chain/post")
