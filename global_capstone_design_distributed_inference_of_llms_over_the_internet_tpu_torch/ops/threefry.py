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
  * ``split(key, n)``: key i is the hash of the counter (0, i), the two
    output words kept (``prng.py:1156`` ``_threefry_split_foldlike``);
  * ``random_bits(key, shape)``: the hash of a 64-bit iota split into
    (high, low) words, the two output words xor-ed
    (``prng.py:1184`` ``_threefry_random_bits_partitionable``);
  * ``uniform``, ``gumbel`` and ``categorical`` as in
    ``jax/_src/random.py:435`` (``_uniform``), ``:1723`` (``_gumbel``) and
    ``:1739`` (``categorical``, the Gumbel-max draw).

A key is either a pair of Python ints or an int64 tensor ``[..., 2]`` of
uint32 words on a device: the traced key of a captured step. ``prng_key``
of a 0-d integer tensor and ``fold_in`` of a tensor key (or tensor data)
run on its device and read nothing back to the host; a leading batch of
keys ``[B, 2]`` draws B rows at once, row r with its own key, as the
reference's ``vmap`` over keys does. uint32 arithmetic runs in int64
tensors (or Python ints) masked with ``0xFFFFFFFF``, which works alike on
the CPU and the card. The bits are exact; ``gumbel`` applies two float32
logarithms, which torch and XLA may round differently in the last ulp.

``categorical`` on a CUDA tensor launches the draw kernel
(``ops/draw_kernel.py``, ``csrc/sample_draw.cu``) or raises;
`categorical_reference` is its plain version, taken for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Key = Union[Tuple[int, int], torch.Tensor]
Word = Union[int, torch.Tensor]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_MANTISSA = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    (x1, x2) under key (k1, k2); words are uint32 values held in Python
    ints or int64 tensors, which broadcast (``prng.py``
    ``_threefry2x32_lowering``)."""
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


def prng_key(seed: Union[int, torch.Tensor]) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off. A Python int
    gives a pair of ints; an integer tensor (a device step index, say)
    gives int64 keys ``[..., 2]`` on its device, without a host read."""
    if isinstance(seed, torch.Tensor):
        lo = seed.to(torch.int64) & MASK
        return torch.stack([torch.zeros_like(lo), lo], dim=-1)
    return 0, int(seed) & MASK


def fold_in(key: Key, data: Union[int, torch.Tensor]) -> Key:
    """``jax.random.fold_in(key, data)``. Ints in, ints out; a tensor key
    or tensor data ([B] folds B keys) gives tensor keys ``[..., 2]``."""
    if not isinstance(key, torch.Tensor) and not isinstance(data, torch.Tensor):
        return threefry2x32(key[0], key[1], 0, int(data) & MASK)
    k1, k2 = (key[..., 0], key[..., 1]) if isinstance(key, torch.Tensor) else key
    return torch.stack(threefry2x32(k1, k2, 0, data & MASK), dim=-1)


def split(key: Key, n: int = 2):
    """``jax.random.split(key, n)``: a list of n pairs of ints for a pair
    of ints; int64 keys ``[..., n, 2]`` for a tensor key ``[..., 2]`` (on
    its device, nothing read back), key i ``threefry2x32(key, (0, i))``."""
    if not isinstance(key, torch.Tensor):
        return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, idx)
    return torch.stack([b1, b2], dim=-1)


def key_tensor(key: Key, device) -> torch.Tensor:
    """`key` as int64 keys ``[..., 2]`` on `device`. A pair of ints is
    written with two fills (no copy from host memory, so it can be
    captured)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    out = torch.full((2,), key[0], dtype=torch.int64, device=device)
    out[1].fill_(key[1])
    return out


def random_bits(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of
    values in [0, 2**32), of shape ``batch + shape`` for keys
    ``[*batch, 2]`` (on the keys' device; `device` for a pair of ints)."""
    n = math.prod(shape)
    if isinstance(key, torch.Tensor):
        batch = tuple(key.shape[:-1])
        k1 = key[..., 0].reshape(*batch, 1)
        k2 = key[..., 1].reshape(*batch, 1)
        device = key.device
    else:
        batch, (k1, k2) = (), key
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape((*batch, *shape))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape, device)
    f_bits = (bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS
    floats = f_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
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


def categorical_reference(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """The plain version of `categorical`: the argmax of Gumbel noise plus
    the float32 logits over the last axis (first index on ties, as
    ``jnp.argmax``). Keys ``[B, 2]`` draw the B rows of logits ``[B, V]``
    each with its own key (the reference's ``vmap``); one key draws its
    noise over the whole shape, as ``jax.random.categorical`` does."""
    logits = logits.float()
    batch = key.ndim - 1 if isinstance(key, torch.Tensor) else 0
    noise = gumbel(key, logits.shape[batch:], logits.device)
    return torch.argmax(noise + logits, dim=-1)


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, int64.
    A CPU tensor takes `categorical_reference`; a CUDA tensor launches the
    draw kernel (``ops/draw_kernel.sample_draw``) or raises."""
    if logits.device.type == "cpu":
        return categorical_reference(key, logits)
    from .draw_kernel import sample_draw

    return sample_draw(key, logits.float()).long()
