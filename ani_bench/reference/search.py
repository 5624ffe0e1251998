"""Plain reference of a search: one query genome against stored genomes,
as ``Database.query`` answers it at skani ``search``'s defaults.

Written from the method: the marker screen, the chain (``ani.py``'s
sketches and chain DP), the aligned-fraction and ANI filters, and the
learned correction of the ANI.  It imports nothing of the port or of the
JAX package and takes nothing the port made: it starts from the genome
bytes that the benchmark handed to both sides, and reads the learned
model's weights from their data file.

* The screen keeps a stored genome whose markers hold the query's
  markers at containment^(1/marker_k) > ``SCREEN_ANI``, or which has
  fewer than ``MIN_MARKERS_RESCUE`` markers (the rescue of small
  genomes).
* A screened genome is a hit where either aligned fraction is at least
  ``MIN_AF`` and its corrected ANI is above ``MIN_ANI_KEEP``.
* The learned correction (skani's default at c >= 70 outside median
  mode) evaluates the model's trees at fixed knots of raw ANI (every
  ``KNOT_STEP`` from ``FADE_LO``, and the calibration's anchors), with
  the query's aligned fractions; each knot's delta is clipped to
  ``MAX_DELTA`` and faded in over ``FADE_LO``-``FADE_HI``; the corrected
  knots are made non-decreasing by a running maximum; the ANI moves by
  the delta interpolated linearly between knots; the result is clamped
  to [0, 1].

Departures from skani: the model is the repository's retrained one
(``pyskani_tpu_torch/data/gbdt_model.json``), since skani's own weights
are not in the repository; the clip, the fade, the knots and the running
maximum are the port's rails around it (its ``regression.py``), which
skani does not have.  The model's thresholds and leaf values are read as
float32, as the port stores them: a split moves with that rounding only
for a feature within about 3e-8 of its threshold.

``precision="bf16"`` is the control: the chain's estimators in bfloat16
(``ani.py``), the screen and the correction unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Sequence

import numpy as np

from . import ani as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODEL_PATH = os.path.join(ROOT, "pyskani_tpu_torch", "data",
                          "gbdt_model.json")

SCREEN_ANI = 0.80             # skani search's screen (pyskani's cutoff=None)
MIN_MARKERS_RESCUE = 20       # stored genomes with fewer markers pass
MIN_AF = 0.15                 # skani's minimum aligned fraction, either side
MIN_ANI_KEEP = 0.1            # hits at or below this are dropped
# the port's rails on the learned correction
FADE_LO, FADE_HI = 0.85, 0.90
KNOT_STEP = 0.01
MAX_DELTA = 0.003


def screen(query: ref.RefSketch, stored: Sequence[ref.RefSketch],
           marker_k: int = ref.MARKER_K) -> np.ndarray:
    """[N] bool: which stored genomes pass the marker screen."""
    out = np.zeros(len(stored), bool)
    nq = len(query.markers)
    for i, s in enumerate(stored):
        nr = len(s.markers)
        est = 0.0
        if nq and nr:
            shared = np.intersect1d(query.markers, s.markers,
                                    assume_unique=True).size
            est = (shared / nq) ** (1.0 / marker_k)
        out[i] = est > SCREEN_ANI or nr < MIN_MARKERS_RESCUE
    return out


@dataclasses.dataclass
class Tree:
    feature: List[int]
    threshold: np.ndarray     # float32
    left: List[int]
    right: List[int]
    value: np.ndarray         # float32

    def leaf(self, x: Sequence[float]) -> float:
        node = 0
        while self.feature[node] >= 0:
            go_left = x[self.feature[node]] <= self.threshold[node]
            node = self.left[node] if go_left else self.right[node]
        return float(self.value[node])


@dataclasses.dataclass
class Model:
    trees: List[Tree]
    base: float
    calib_x: np.ndarray
    calib_y: np.ndarray

    def predict(self, x: Sequence[float]) -> float:
        """The ensemble's corrected ANI at features (ani, af_query,
        af_ref): the base, every tree's leaf, and the calibration's delta
        at the ANI (linear between its points)."""
        out = self.base + sum(t.leaf(x) for t in self.trees)
        if len(self.calib_x):
            out += float(np.interp(x[0], self.calib_x, self.calib_y))
        return out


def load_model(path: str = MODEL_PATH) -> Model:
    with open(path) as f:
        raw = json.load(f)
    trees = [Tree(list(t["feature"]), np.asarray(t["threshold"], np.float32),
                  list(t["left"]), list(t["right"]),
                  np.asarray(t["value"], np.float32)) for t in raw["trees"]]
    calib = raw.get("calibration") or {"x": [], "y": []}
    return Model(trees, float(raw.get("base", 0.0)),
                 np.asarray(calib["x"], np.float64),
                 np.asarray(calib["y"], np.float64))


def knots(model: Model) -> np.ndarray:
    n = int(round((1.0 - FADE_LO) / KNOT_STEP))
    grid = [FADE_LO + KNOT_STEP * i for i in range(n + 1)]
    anchors = [x for x in model.calib_x if FADE_LO < x < 1.0]
    return np.unique(np.asarray(grid + anchors, np.float64))


def correct(model: Model, ani: float, af_q: float, af_r: float) -> float:
    """The learned correction of a raw ANI (not yet clamped)."""
    kx = knots(model)
    fixed = []
    for x in kx:
        delta = min(max(model.predict((x, af_q, af_r)) - x, -MAX_DELTA),
                    MAX_DELTA)
        weight = min(max((x - FADE_LO) / (FADE_HI - FADE_LO), 0.0), 1.0)
        fixed.append(x + weight * delta)
    fixed = np.maximum.accumulate(np.asarray(fixed))
    return ani + float(np.interp(ani, kx, fixed - kx))


def search(query: ref.RefSketch, stored: Sequence[ref.RefSketch],
           model: Model, *, k: int = ref.K, marker_k: int = ref.MARKER_K,
           precision: str = "f64") -> List[dict]:
    """Per stored genome: ``screened``, ``hit``, and for a screened one
    its corrected ``ani`` (clamped to [0, 1]), ``af_query`` and
    ``af_ref``."""
    passed = screen(query, stored, marker_k)
    idx = np.nonzero(passed)[0]
    chained = ref.chain_pairs([(stored[i], query) for i in idx], k=k,
                              precision=precision) if len(idx) else []
    out = [{"screened": False, "hit": False} for _ in stored]
    for i, r in zip(idx, chained):
        ani = correct(model, r["ani"], r["af_query"], r["af_ref"])
        keep = (r["af_query"] >= MIN_AF or r["af_ref"] >= MIN_AF) and \
            ani > MIN_ANI_KEEP
        out[i] = {"screened": True, "hit": bool(keep),
                  "ani": min(max(ani, 0.0), 1.0),
                  "af_query": r["af_query"], "af_ref": r["af_ref"]}
    return out
