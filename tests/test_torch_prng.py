"""Port ``ops/prng.py`` vs JAX's generator.

The bootstrap's index tables must equal
``jax.random.randint(PRNGKey(1539), (100, M), 0, n)`` bit for bit, and
the raw Threefry-2x32 output must equal ``jax._src.prng.threefry_2x32``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from pyskani_tpu_torch.ops import prng

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(1539)


def test_key_matches_jax():
    assert tuple(int(x) for x in np.asarray(KEY)) == prng.prng_key(1539)
    split = np.asarray(jax.random.split(KEY))
    assert [tuple(int(x) for x in k) for k in split] == \
        prng.split(prng.prng_key(1539))


@pytest.mark.parametrize("M", [1, 7, 256, 1000, 1 << 17])
def test_randint_tables_bit_equal(M):
    high, low = prng.bootstrap_bits(100, M, "cpu")
    for n in sorted({1, 2, 3, 97, M}):
        want = np.asarray(jax.random.randint(KEY, (100, M), 0, n))
        got = prng.randint_from_bits(high, low, torch.tensor(n)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"M={M} n={n}")
        assert got.min() >= 0 and got.max() < n


def test_randint_per_row_span_matches_vmapped_jax():
    """One span per row, as ``_pooled_estimators`` draws under ``vmap``
    in the JAX package; spans of 0 draw from [0, 1)."""
    spans = np.array([0, 1, 5, 300, 1000], np.int32)
    want = np.asarray(jax.vmap(lambda n: jax.random.randint(
        KEY, (100, 1000), 0, jnp.maximum(n, 1)))(jnp.asarray(spans)))
    high, low = prng.bootstrap_bits(100, 1000, "cpu")
    got = prng.randint_from_bits(
        high, low, torch.clamp(torch.from_numpy(spans).long(), min=1).view(
            -1, 1, 1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key", [(0, 1539), (0xDEADBEEF, 0xFFFFFFFF), (7, 0)])
def test_threefry_raw_bit_equal(key):
    rng = np.random.default_rng(11)
    count = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_prng.threefry_2x32(
        jnp.asarray(np.array(key, np.uint32)), jnp.asarray(count)))
    # the JAX wrapper hashes the first half of the counts against the second
    c = torch.from_numpy(count.astype(np.int64))
    a, b = prng.threefry2x32(key[0], key[1], c[:2048], c[2048:])
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(),
                                  want.astype(np.int64))


def test_bits_are_cached_per_shape_and_device():
    """The last shape's int32 tables stay cached on each device; another
    shape replaces them."""
    a = prng.bootstrap_bits(100, 64, "cpu")
    assert all(t.dtype == torch.int32 and t.shape == (100, 64) for t in a)
    assert prng.bootstrap_bits(100, 64, torch.device("cpu")) is a
    b = prng.bootstrap_bits(100, 65, "cpu")
    assert b is not a and b[0].shape == (100, 65)
    assert prng.bootstrap_bits(100, 65, "cpu") is b
    again = prng.bootstrap_bits(100, 64, "cpu")
    assert again is not a and all(torch.equal(x, y) for x, y in zip(again, a))
