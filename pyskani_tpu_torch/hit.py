"""Hit: one query result.

API-parity port of pyskani's ``Hit`` pyclass
(``_skani/hit.rs:18-123``; copy of the JAX package's ``hit.py``): same constructor
validation (values in [0, 1] else ValueError), same attribute surface,
same repr format.  Values are stored as float32 like the reference's
``AniEstResult`` (f32 fields, hit.rs:50-55).  ``screened_hits`` is the
rule that makes hits of chained pairs, for every searcher.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np

from . import regression
from .params import MIN_ANI_KEEP, CommandParams


class Hit:
    __slots__ = ("_identity", "_query_name", "_query_fraction",
                 "_reference_name", "_reference_fraction",
                 "_ci_low", "_ci_high")

    def __init__(self, identity: float, query_name: str,
                 query_fraction: float, reference_name: str,
                 reference_fraction: float, *,
                 ci_low: float | None = None,
                 ci_high: float | None = None):
        identity = float(np.float32(identity))
        query_fraction = float(np.float32(query_fraction))
        reference_fraction = float(np.float32(reference_fraction))
        if not 0.0 <= identity <= 1.0:
            raise ValueError(f"Invalid value for `identity`: {identity}")
        if not 0.0 <= query_fraction <= 1.0:
            raise ValueError(
                f"Invalid value for `query_fraction`: {query_fraction}")
        if not 0.0 <= reference_fraction <= 1.0:
            raise ValueError(
                f"Invalid value for `reference_fraction`: {reference_fraction}")
        for label, val in (("ci_low", ci_low), ("ci_high", ci_high)):
            if val is not None and not 0.0 <= float(val) <= 1.0:
                raise ValueError(f"Invalid value for `{label}`: {val}")
        self._identity = identity
        self._query_name = query_name
        self._query_fraction = query_fraction
        self._reference_name = reference_name
        self._reference_fraction = reference_fraction
        self._ci_low = None if ci_low is None else float(np.float32(ci_low))
        self._ci_high = None if ci_high is None else float(np.float32(ci_high))

    @property
    def identity(self) -> float:
        return self._identity

    @property
    def query_name(self) -> str:
        return self._query_name

    @property
    def query_fraction(self) -> float:
        return self._query_fraction

    @property
    def reference_name(self) -> str:
        return self._reference_name

    @property
    def reference_fraction(self) -> float:
        return self._reference_fraction

    @property
    def ci_low(self) -> float | None:
        """Lower bound of the [5%, 95%] percentile-bootstrap ANI CI
        (populated when the query ran with ``est_ci=True``; extension
        over the reference surface — skani's --ci)."""
        return self._ci_low

    @property
    def ci_high(self) -> float | None:
        """Upper bound of the [5%, 95%] percentile-bootstrap ANI CI."""
        return self._ci_high

    def __repr__(self) -> str:
        return ("Hit(identity={!r}, query_name={!r}, query_fraction={!r}, "
                "reference_name={!r}, reference_fraction={!r})").format(
            self._identity, self._query_name, self._query_fraction,
            self._reference_name, self._reference_fraction)


def estimator_key(median: bool, robust: bool) -> str:
    """The chain output a query reports as its ANI."""
    return "ani_median" if median else "ani_robust" if robust else "ani_mean"


def screened_hits(est: Mapping[str, np.ndarray], query_names, ref_names,
                  c: int, learned_ani: Optional[bool], median: bool,
                  robust: bool, device) -> Tuple[List[Hit], np.ndarray, bool]:
    """(hits, their pair indices, corrected) of flat arrays of screened
    pairs: chain outputs ``est``, names ``query_names`` / ``ref_names``.
    The learned model (skani's ``use_learned_ani`` at compression ``c`` by
    default) corrects the mean only, in one batch on ``device``.  A hit
    has an aligned fraction of at least ``CommandParams().min_aligned_frac``
    and an ANI above ``MIN_ANI_KEEP``, clamped to [0, 1] as are its CI."""
    learned = learned_ani if learned_ani is not None else \
        regression.use_learned_ani(c, False, False, median)
    model = regression.get_model(c, learned)
    af_q, af_r, ani = (np.asarray(est[k], np.float64) for k in
                       ("af_query", "af_ref", estimator_key(median, robust)))
    corrected = model is not None and not median and not robust \
        and len(ani) > 0
    if corrected:
        ani = regression.apply_model_batch(model, ani, af_q, af_r, device)
    maf = CommandParams().min_aligned_frac
    kept = np.nonzero(~((af_q < maf) & (af_r < maf)) & (ani > MIN_ANI_KEEP))[0]
    ani = np.clip(ani, 0.0, 1.0)
    ci = np.clip(np.stack([est["ani_ci_low"], est["ani_ci_high"]]), 0.0,
                 1.0) if "ani_ci_low" in est else None
    hits = []
    for i in kept:
        bounds = {} if ci is None else dict(ci_low=float(ci[0, i]),
                                            ci_high=float(ci[1, i]))
        hits.append(Hit(float(ani[i]), query_names[i], float(af_q[i]),
                        ref_names[i], float(af_r[i]), **bounds))
    return hits, kept, corrected
