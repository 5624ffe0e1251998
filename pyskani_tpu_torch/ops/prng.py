"""JAX's counter-based random generator, as far as ``randint`` needs it.

The bootstrap of the ANI confidence interval (``ops/chain.py``) draws its
resample indices as the JAX package does,
``jax.random.randint(jax.random.PRNGKey(1539), (R, M), 0, n)``, so the
port's interval bounds are comparable with the JAX package's bit for bit.
This module reproduces that draw without JAX (JAX 0.9 with
``jax_threefry_partitionable`` on, its default):

* ``threefry2x32``: the Threefry-2x32 block cipher (20 rounds, key
  schedule with the 0x1BD11BDA parity word);
* ``split``: the partitionable key split, one cipher call on the
  (hi, lo) words of a 64-bit iota;
* ``random_bits``: 32 random bits per element, the xor of the two cipher
  words of the element's 64-bit counter;
* ``randint_from_bits``: ``_randint``'s two draws (high and low bits)
  mapped into [0, span) by the modulus that JAX uses, 2^32 mod span
  folded in with u32 wraparound.

PyTorch has no uint32 arithmetic: the cipher rounds run on int32 words,
whose adds wrap with the bits of u32 adds, and the modulus works on u32
values in int64 tensors, masked after each add and multiply, as
``ops/sketch.py`` does.  The key and the shape of a bootstrap are the same
for every pair; only the span differs per row, so ``bootstrap_bits``
keeps the [R, M] tables of high and low bits (int32 words, 8 B per index)
for the last shape asked on each device.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CI_SEED = 1539   # the JAX package's bootstrap key, PRNGKey(1539)


def _i32(v: int) -> int:
    """A u32 value as the int32 with the same bits."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _threefry_i32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 rounds on int32 words in place: adds wrap mod 2^32
    with the bits of u32 adds, and the right shift of a rotation is
    masked to a logical one.  Returns the two output words as int32."""
    ks = (_i32(k1), _i32(k2), _i32(k1 ^ k2 ^ 0x1BD11BDA))
    a = x1.to(torch.int32).add_(ks[0])
    b = x2.to(torch.int32).add_(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b)
            b = torch.bitwise_or(b << r, (b >> (32 - r)).bitwise_and_(
                (1 << r) - 1)).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3])
        b.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return a, b


def threefry2x32(k1: int, k2: int, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the counter words ``(x1, x2)`` (u32 values in
    int64 tensors of one shape) under the key ``(k1, k2)``; returns the
    two output words the same way."""
    a, b = _threefry_i32(k1, k2, x1, x2)
    return a.to(torch.int64) & _M32, b.to(torch.int64) & _M32


def _iota_2x32(n: int, device):
    """(hi, lo) words of the 64-bit counters 0..n-1."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & _M32


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return 0, seed & _M32


def split(key, device="cpu"):
    """The two keys of ``jax.random.split(key)`` (partitionable form)."""
    hi, lo = _iota_2x32(2, device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return [(int(b1[i]), int(b2[i])) for i in range(2)]


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element of ``shape``, as the int32 words with
    the same bits."""
    n = 1
    for d in shape:
        n *= d
    hi, lo = _iota_2x32(n, device)
    b1, b2 = _threefry_i32(key[0], key[1], hi, lo)
    return b1.bitwise_xor_(b2).reshape(shape)


# device -> (R, M, (high, low)): the last shape's tables on each device
_TABLES: dict = {}


def bootstrap_bits(R: int, M: int, device):
    """(high, low) [R, M] int32 bit tables of ``randint(PRNGKey(1539),
    (R, M), ...)``; only the last shape asked on a device stays cached."""
    dev = str(torch.device(device))
    hit = _TABLES.get(dev)
    if hit is None or hit[:2] != (R, M):
        k_hi, k_lo = split(prng_key(CI_SEED))
        _TABLES[dev] = hit = (R, M, (random_bits(k_hi, (R, M), dev),
                                     random_bits(k_lo, (R, M), dev)))
    return hit[2]


def randint_from_bits(high: torch.Tensor, low: torch.Tensor,
                      span: torch.Tensor) -> torch.Tensor:
    """JAX's ``_randint`` mapping of two int32 bit tables into [0, span):
    ``((high % span) * m + low % span) % span`` with m = 2^32 mod span
    and u32 wraparound.  ``span`` (>= 1) broadcasts against the tables;
    returns int64 indices of the broadcast shape."""
    span = span.to(torch.int64)
    m = (65536 % span) * (65536 % span) % span
    off = (high.to(torch.int64) & _M32) % span
    off.mul_(m).bitwise_and_(_M32)
    off.add_((low.to(torch.int64) & _M32) % span).bitwise_and_(_M32)
    return off.remainder_(span)
