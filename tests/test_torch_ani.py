"""Golden-value ANI conformance of the port (E. coli EC590 vs K-12), on
the CPU: the same five goldens as tests/test_ani.py at 4 decimals."""

import pytest
import torch

import pyskani_tpu_torch

torch.set_num_threads(1)

GOLD_AF_QUERY = 0.9189
GOLD_AF_REF = 0.9246


@pytest.fixture(scope="module")
def db(ecoli_ec590):
    database = pyskani_tpu_torch.Database(device="cpu")
    database.sketch("EC590", ecoli_ec590)
    return database


@pytest.mark.parametrize("mode,kw,gold", [
    ("raw", dict(learned_ani=False), 0.9946),
    ("learned", dict(learned_ani=True), 0.9939),
    ("default", {}, 0.9939),
    ("robust", dict(robust=True), 0.9977),
    ("median", dict(median=True), 0.9995),
])
def test_golden(db, ecoli_k12, mode, kw, gold):
    hits = db.query("K12", ecoli_k12, **kw)
    assert len(hits) == 1
    h = hits[0]
    assert h.reference_name == "EC590" and h.query_name == "K12"
    assert round(h.query_fraction - GOLD_AF_QUERY, 4) == 0
    assert round(h.reference_fraction - GOLD_AF_REF, 4) == 0
    assert round(h.identity - gold, 4) == 0
