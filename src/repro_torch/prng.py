"""Seed-exact counter-based PRNG: JAX's threefry2x32, bit for bit.

The subset of `jax.random` that the compressed-correction strategies and
the Section 4 Rademacher estimate draw from (`PRNGKey`, `split`,
`fold_in`, random bits, `uniform`, `bernoulli`, `rademacher`), equal to
jax 0.9's default `threefry2x32` implementation with
`jax_threefry_partitionable=True`:

  * a key is two uint32 words; `PRNGKey(seed)` is (seed >> 32, seed & M);
  * `split(key, num)` hashes the counters (hi, lo) of iota(num) under key
    and stacks the two output words as the new keys;
  * `fold_in(key, d)` hashes the counter pair (0, d) under key;
  * the bits of a draw of `shape` hash the counters of the row-major flat
    index (hi and lo words of the index) under key: 32-bit draws are
    `bits1 ^ bits2`, 64-bit draws `(bits1 << 32) | bits2`;
  * `uniform` keeps the top mantissa bits of a draw: OR-ed into 1.0 and
    minus 1 in JAX, here the same value as mantissa * 2^-nmant;
  * `bernoulli(key, p, shape)` is `uniform(key, shape, dtype of p) < p`
    (jax's default "low" mode), and `rademacher` is 2 * bernoulli(key,
    0.5) - 1 in the target dtype.

Keys are int64 tensors of shape (2,) holding the two words, on the CPU:
`split` and `fold_in` hash single counters, which Python integers do in
microseconds where a tensor op costs a launch.  The draws themselves are
tensor code on the requested device.  torch has no uint32 shifts on every
device, so all word arithmetic runs in int64 on values in [0, 2^32),
masked after every add and shift; `>>` on int64 is arithmetic, which is
logical for those non-negative values.  A 64-bit draw does not fit a
signed int64, so the 52-bit f64 mantissa is built from the two words.

randint, normal and permutation are not ported yet (ROADMAP Queue 1
item 4).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .device import DeviceLike, resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: Word, k2: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k1, k2).  Words are Python ints or int64 tensors with
    values in [0, 2^32); the result has the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    if len(k) != 2:
        raise ValueError(f"a key is two uint32 words, got shape {tuple(key.shape)}")
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def _key(w0: int, w1: int) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 64-bit integer seed (as under
    `jax_enable_x64`): the words (seed >> 32, seed & 0xFFFFFFFF) of its
    two's-complement bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _key(seed >> 32, seed & MASK32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: data is taken as uint32."""
    k1, k2 = _words(key)
    return _key(*threefry2x32(k1, k2, 0, int(data) & MASK32))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2] keys, hashes of the counters
    (0, i) (num < 2^32)."""
    k1, k2 = _words(key)
    return torch.stack([_key(*threefry2x32(k1, k2, 0, i)) for i in range(num)])


def _counters(shape: Sequence[int], device: torch.device):
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def _bits_pair(key: torch.Tensor, shape: Sequence[int], device: torch.device):
    k1, k2 = _words(key)
    hi, lo = _counters(shape, device)
    return threefry2x32(k1, k2, hi, lo)


def random_bits(
    key: torch.Tensor, bit_width: int, shape: Sequence[int],
    device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.bits` words as int64 values of `shape`: 32-bit draws in
    [0, 2^32); 64-bit draws as their two's-complement int64 bits."""
    device = resolve_device(device)
    b1, b2 = _bits_pair(key, shape, device)
    if bit_width == 32:
        out = b1 ^ b2
    elif bit_width == 64:
        out = (b1 << 32) | b2  # wraps into the sign bit, as a bit pattern
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return out.reshape(tuple(shape))


def uniform(
    key: torch.Tensor, shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float64, device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype)` on [0, 1), bit for bit, in
    f64 or f32.  JAX draws f64 when `jax_enable_x64` is on and no dtype is
    given, which is how every strategy of the repository draws."""
    device = resolve_device(device)
    b1, b2 = _bits_pair(key, shape, device)
    if dtype == torch.float64:
        # the top 52 of the 64 bits (b1 << 32 | b2) >> 12, from the words
        mant = (b1 << 20) | (b2 >> 12)
        out = mant.to(torch.float64) * 2.0 ** -52
    elif dtype == torch.float32:
        mant = (b1 ^ b2) >> 9
        out = mant.to(torch.float32) * 2.0 ** -23
    else:
        raise ValueError(f"uniform draws float64 or float32, got {dtype}")
    return out.reshape(tuple(shape))


def bernoulli(
    key: torch.Tensor, p: Union[float, torch.Tensor] = 0.5,
    shape: Optional[Sequence[int]] = None, device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: bool draws, True with
    probability p, bit for bit.  The uniforms take p's dtype: a Python
    float is weakly typed in JAX, hence f64 under `jax_enable_x64` (as
    everywhere in the repository); a tensor p keeps its f32 or f64.
    `shape` defaults to p's shape; `device` to p's for a tensor p."""
    if isinstance(p, torch.Tensor):
        dtype = p.dtype
        if device is None:
            device = p.device
        if shape is None:
            shape = tuple(p.shape)
    else:
        dtype = torch.float64
        shape = () if shape is None else shape
    device = resolve_device(device)
    if isinstance(p, torch.Tensor):
        p = p.to(device)
    return uniform(key, tuple(shape), dtype, device) < p


def rademacher(
    key: torch.Tensor, shape: Sequence[int] = (),
    dtype: torch.dtype = torch.int64, device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.rademacher(key, shape, dtype)`: +1 / -1 draws, bit for
    bit (2 * bernoulli(key, 0.5, shape) - 1 in `dtype`; JAX's default
    integer dtype under x64 is int64)."""
    b = bernoulli(key, 0.5, shape, device).to(dtype)
    return (2 * b - 1).to(dtype)
