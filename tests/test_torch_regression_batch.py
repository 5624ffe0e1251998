"""The batched learned correction (``regression.apply_model_batch``)
against the JAX package's ``regression.apply_model``, row by row.

The JAX package's ``apply_model`` walks 200 trees in NumPy for each row
(~25 ms a row), so the reference evaluates its model's ``predict`` once
over every row's knot rows and hands each ``apply_model`` call its own
block: ``predict`` is elementwise per row, so a row's block is the one
its own call would compute (``test_reference_equals_unbatched`` holds
that), and everything else of ``apply_model`` runs as it is.

The JAX package is imported inside the reference alone: the ``cuda``
test imports none of it, so on the card it runs with ``python -m pytest
--noconftest tests/test_torch_regression_batch.py -k cuda``.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from pyskani_tpu_torch import regression

TOL = 1e-12
# af values away from every tree threshold
AFS = (0.0, 0.07, 0.2, 0.55, 0.9, 1.0)


def _model():
    return regression.get_model(125, True)


def _chunk_hits():
    m = _model()
    return regression._CHUNK_ELEMS // (m.feature.shape[0]
                                       * len(regression._correction_knots(m)))


def _grid(anis, afs=AFS):
    a, q, r = np.meshgrid(np.asarray(anis, np.float64), afs, afs,
                          indexing="ij")
    return a.ravel(), q.ravel(), r.ravel()


def _knots():
    return _grid(regression._correction_knots(_model()))


def _ends():
    # 0, 1, below the fade (0.85), and above the last knot
    return _grid([0.0, 0.1, 0.5, 0.8, 0.849999, np.nextafter(0.85, 0),
                  np.nextafter(1.0, 0), 1.0, np.nextafter(1.0, 2),
                  1.0 + 1e-6, 1.5])


def _thresholds():
    """af_query and af_ref at each float32 threshold of their trees'
    splits, and one float64 step to either side."""
    m = _model()
    thr = np.unique(m.threshold[np.isin(m.feature, (1, 2))].astype(
        np.float64))
    afs = np.concatenate([thr, np.nextafter(thr, -1), np.nextafter(thr, 2)])
    afs = afs[(afs >= 0) & (afs <= 1)]
    rng = np.random.default_rng(5)
    n = len(afs)
    return (rng.uniform(0.84, 1.0, 2 * n),
            np.concatenate([afs, rng.permutation(afs)]),
            np.concatenate([rng.permutation(afs), afs]))


def _one():
    return np.array([0.9946391582489014]), np.array([0.93]), \
        np.array([0.91])


def _empty():
    return np.zeros(0), np.zeros(0), np.zeros(0)


def _large():
    # past four chunks of hits, so the last chunk is a partial one
    n = 4 * _chunk_hits() + 101
    rng = np.random.default_rng(7)
    return (rng.uniform(0.75, 1.0, n), rng.uniform(0.0, 1.0, n),
            rng.uniform(0.0, 1.0, n))


CASES = {"knots": _knots, "ends": _ends, "thresholds": _thresholds,
         "one": _one, "empty": _empty, "large": _large}


def _reference(ani, af_q, af_r):
    """[H] float64: the JAX package's ``apply_model`` of every row."""
    from pyskani_tpu import regression as jax_regression
    jm = jax_regression.get_model(125, True)
    kx = jax_regression._correction_knots(jm)
    K, H = len(kx), len(ani)
    x = np.stack([np.tile(kx, H), np.repeat(af_q, K), np.repeat(af_r, K)],
                 axis=1)
    pred = jm.predict(x)
    row = iter(range(H))

    class Batched:
        calib_x = jm.calib_x

        def predict(self, rows):
            i = next(row)
            np.testing.assert_array_equal(rows, x[i * K:(i + 1) * K])
            return pred[i * K:(i + 1) * K]

    m = Batched()
    return np.array([jax_regression.apply_model(m, a, q, r)
                     for a, q, r in zip(ani, af_q, af_r)], np.float64)


def test_reference_equals_unbatched():
    from pyskani_tpu import regression as jax_regression
    jm = jax_regression.get_model(125, True)
    ani, af_q, af_r = (v[::97] for v in _thresholds())
    want = [jax_regression.apply_model(jm, a, q, r)
            for a, q, r in zip(ani, af_q, af_r)]
    assert list(_reference(ani, af_q, af_r)) == want


def test_cases_cover_ten_thousand_rows():
    assert sum(len(f()[0]) for f in CASES.values()) >= 10_000
    assert len(_large()[0]) > 4 * _chunk_hits()


@pytest.mark.parametrize("case", list(CASES))
def test_batch_equals_jax_apply_model(case):
    ani, af_q, af_r = CASES[case]()
    got = regression.apply_model_batch(_model(), ani, af_q, af_r, "cpu")
    assert got.dtype == np.float64 and got.shape == ani.shape
    if len(ani):
        np.testing.assert_allclose(got, _reference(ani, af_q, af_r),
                                   rtol=0, atol=TOL)


def test_chunk_size_changes_nothing(monkeypatch):
    """Rows cut into chunks of 3 hits give what one chunk gives."""
    ani, af_q, af_r = (v[:40] for v in _large())
    whole = regression.apply_model_batch(_model(), ani, af_q, af_r)
    m = _model()
    monkeypatch.setattr(regression, "_CHUNK_ELEMS",
                        3 * m.feature.shape[0]
                        * len(regression._correction_knots(m)))
    cut = regression.apply_model_batch(_model(), ani, af_q, af_r)
    np.testing.assert_array_equal(cut, whole)


def test_scalar_apply_model_is_its_batch_row():
    ani, af_q, af_r = (v[::7] for v in _knots())
    batch = regression.apply_model_batch(_model(), ani, af_q, af_r)
    for i, (a, q, r) in enumerate(zip(ani, af_q, af_r)):
        got = regression.apply_model(_model(), float(a), float(q), float(r))
        assert isinstance(got, float) and got == batch[i]


def test_without_model_rows_pass_through():
    ani = np.array([0.9, 0.95, 0.99])
    out = regression.apply_model_batch(None, ani, ani, ani)
    assert out.dtype == np.float64 and list(out) == list(ani)
    assert regression.apply_model(None, 0.95, 0.9, 0.9) == 0.95


def test_get_model_parses_the_file_once(tmp_path, monkeypatch):
    path = str(tmp_path / "gbdt_model.json")
    shutil.copy(regression._MODEL_PATH, path)
    monkeypatch.setattr(regression, "_MODEL_PATH", path)
    parsed = []
    load = json.load

    def counted(f, *a, **kw):
        parsed.append(f.name)
        return load(f, *a, **kw)

    monkeypatch.setattr(json, "load", counted)
    models = [regression.get_model(125, True) for _ in range(3)]
    assert parsed == [path]
    assert models[0] is not None and all(m is models[0] for m in models)
    assert regression.get_model(125, False) is None


def test_missing_model_warns_once(tmp_path, monkeypatch):
    monkeypatch.setattr(regression, "_MODEL_PATH",
                        str(tmp_path / "absent.json"))
    monkeypatch.setattr(regression, "_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert regression.get_model(125, True) is None
        assert regression.get_model(125, True) is None
    assert [w.category for w in caught] == [RuntimeWarning]
    assert not os.path.exists(regression._MODEL_PATH)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["knots", "ends", "thresholds", "large"])
def test_cuda_batch_equals_cpu(case):
    """On the card the pass equals the CPU's (which the tests above hold
    to the JAX package) within the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ani, af_q, af_r = CASES[case]()
    got = regression.apply_model_batch(_model(), ani, af_q, af_r, "cuda")
    want = regression.apply_model_batch(_model(), ani, af_q, af_r, "cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
