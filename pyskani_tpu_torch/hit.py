"""Hit: one query result.

API-parity port of pyskani's ``Hit`` pyclass
(``_skani/hit.rs:18-123``; copy of the JAX package's ``hit.py``): same constructor
validation (values in [0, 1] else ValueError), same attribute surface,
same repr format.  Values are stored as float32 like the reference's
``AniEstResult`` (f32 fields, hit.rs:50-55).
"""

from __future__ import annotations

import numpy as np


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
