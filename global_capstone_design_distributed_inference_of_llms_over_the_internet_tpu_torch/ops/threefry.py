"""JAX's threefry2x32 random numbers in PyTorch, bit for bit.

The JAX package draws its sampled tokens from ``jax.random`` keys; this
module is the port's stand-in, so a seeded sampled run of the port draws
the same tokens as the reference. It reproduces jax 0.9's default
implementation (``threefry2x32``, ``jax_threefry_partitionable=True``,
64-bit mode off, Gumbel ``mode="low"``):

  * ``prng_key(seed)``: the key ``(0, seed mod 2**32)``
    (``jax/_src/prng.py`` ``threefry_seed``, the seed taken as 32 bits);
  * ``fold_in(key, data)``: ``threefry_2x32(key, (0, data))``
    (``prng.py:1163`` ``threefry_fold_in``);
  * ``random_bits(key, shape)``: the hash of a 64-bit iota split into
    (high, low) words, the two output words xor-ed
    (``prng.py:1184`` ``_threefry_random_bits_partitionable``);
  * ``uniform``, ``gumbel`` and ``categorical`` as in
    ``jax/_src/random.py:435`` (``_uniform``), ``:1723`` (``_gumbel``) and
    ``:1739`` (``categorical``, the Gumbel-max draw).

A key is a pair of Python ints. uint32 arithmetic runs in int64 tensors
(or Python ints, for keys) masked with ``0xFFFFFFFF``, which works alike on
the CPU and the card. The bits are exact; ``gumbel`` applies two float32
logarithms, which torch and XLA may round differently in the last ulp.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_MANTISSA = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1: int, k2: int, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    (x1, x2) under key (k1, k2); words are uint32 values held in Python
    ints or int64 tensors (``prng.py`` ``_threefry2x32_lowering``)."""
    ks = (k1 & MASK, k2 & MASK, (k1 ^ k2 ^ _PARITY) & MASK)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def random_bits(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of
    values in [0, 2**32)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape, device)
    f_bits = (bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS
    floats = f_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    # XLA fuses floats * (hi - lo) + lo into one FMA: the float64 product
    # is exact, so one rounding of the float64 sum to float32 gives the
    # FMA's value (bar a double-rounding tie).
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"`` (the default):
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    u = uniform(key, shape, _F32_TINY, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of Gumbel noise plus the float32 logits (first index on ties,
    as ``jnp.argmax``)."""
    logits = logits.float()
    noise = gumbel(key, logits.shape, logits.device)
    return torch.argmax(noise + logits, dim=-1)
