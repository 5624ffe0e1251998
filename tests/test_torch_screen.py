"""Port marker screen vs the JAX package's ``screen_batch``.

Pass decisions must be equal and the containment estimates within 1e-6
(f32 ``pow`` may differ in the last ulp between PyTorch and XLA).
"""

import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu.ops.screen import screen_batch as j_screen
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch.ops.screen import screen_batch as t_screen

torch.set_num_threads(1)

P = SketchParams()


def _markers(host, M):
    d = host.device
    m = int(d.n_markers)
    hi = np.full(M, 0xFFFFFFFF, np.uint32)
    lo = np.full(M, 0xFFFFFFFF, np.uint32)
    hi[:m] = np.asarray(d.markers_hi[:m])
    lo[:m] = np.asarray(d.markers_lo[:m])
    return hi, lo, m


@pytest.fixture(scope="module")
def sketches():
    rng = np.random.default_rng(11)
    base = random_genome(rng, 80_000)
    genomes = [base, mutate(rng, base, 0.02), mutate(rng, base, 0.10),
               mutate(rng, base, 0.20), random_genome(rng, 80_000),
               random_genome(rng, 3_000)]      # < 20 markers: rescued
    hosts = [sketch_genome_device(f"g{i}", [g], P, length_bucket=1 << 17)
             for i, g in enumerate(genomes)]
    query = sketch_genome_device("q", [mutate(rng, base, 0.01)], P,
                                 length_bucket=1 << 17)
    return query, hosts


@pytest.mark.parametrize("screen_val,rescue",
                         [(0.80, True), (0.95, True), (0.0, True),
                          (0.80, False)])
def test_screen_batch_matches_jax(sketches, screen_val, rescue):
    query, hosts = sketches
    M = 1024
    rows = [_markers(h, M) for h in hosts]
    hi = np.stack([r[0] for r in rows])
    lo = np.stack([r[1] for r in rows])
    counts = np.array([r[2] for r in rows], np.int32)
    qhi, qlo, qn = _markers(query, 512)
    want_pass, want_est = j_screen(qhi, qlo, np.int32(qn), hi, lo, counts,
                                   screen_val, marker_k=P.marker_k,
                                   rescue_small=rescue)
    got_pass, got_est = t_screen(
        torch.from_numpy(qhi.astype(np.int64)),
        torch.from_numpy(qlo.astype(np.int64)), qn,
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(counts),
        screen_val, marker_k=P.marker_k, rescue_small=rescue)
    np.testing.assert_array_equal(got_pass.numpy(), np.asarray(want_pass))
    np.testing.assert_allclose(got_est.numpy(), np.asarray(want_est),
                               rtol=0, atol=1e-6)
    # the fixture spans every branch: passes, fails, and the rescue
    if screen_val == 0.80:
        assert got_pass[0] and not got_pass[4]
        assert bool(got_pass[5]) == rescue
