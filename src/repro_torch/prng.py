"""Seed-exact counter-based PRNG: JAX's threefry2x32, bit for bit.

The subset of `jax.random` that the repository draws from (`PRNGKey`,
`split`, `fold_in`, random bits, `uniform`, `bernoulli`, `rademacher`,
`randint`, `permutation` and `normal`), equal to jax 0.9's default
`threefry2x32` implementation with `jax_threefry_partitionable=True`:

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
    0.5) - 1 in the target dtype;
  * `randint` splits the key, draws two words of the dtype's width and
    reduces them with JAX's span / multiplier remainder identity, in
    exact int64 arithmetic (16-bit partial products, so nothing wraps);
  * `permutation(key, n)` runs ceil(3 ln n / ln(2^32 - 1)) rounds of a
    split, 32-bit sort keys and a stable sort;
  * `normal` is sqrt(2) * erf_inv(u) for u uniform on (nextafter(-1, 0),
    1), the scaled uniform bit for bit, erf_inv as XLA's polynomial (the
    CHLO decomposition: f32 split at w = 5, f64 at 6.25 and 16) in fused
    multiply-adds.  Its `log1p` is torch's, another implementation than
    XLA's, so a normal draw agrees with JAX's to a few ulp, not bit for
    bit (tests/test_torch_prng.py states the bound).

Keys are int64 tensors whose last axis holds the two words, on the CPU:
one key has shape (2,), a batch of keys [..., 2].  A single key's `split`
and `fold_in` hash Python integers (microseconds, where a tensor op costs
a launch); a batch hashes numpy uint32 words.  Every draw takes either a
key or a batch: a [B..., 2] batch gives [B..., *shape] draws in one
threefry pass (the key words broadcast against the counters), equal to
stacking the single-key draws.  The draws themselves are tensor code on
the requested device.  torch has no uint32 shifts on every device, so all
word arithmetic runs in int64 on values in [0, 2^32), masked after every
add and shift; `>>` on int64 is arithmetic, which is logical for those
non-negative values.  A 64-bit draw does not fit a signed int64, so the
52-bit f64 mantissa is built from the two words.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike, host_to_device, not_ported, resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, np.ndarray, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: Word, k2: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k1, k2).  Words are Python ints, int64 tensors or
    numpy int64 arrays with values in [0, 2^32) (tensors and arrays
    broadcast); the result has the same form."""
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


def _check_key(key: torch.Tensor) -> None:
    if key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(
            f"a key is two uint32 words, got shape {tuple(key.shape)}")


def _words(key: torch.Tensor) -> Tuple[int, int]:
    _check_key(key)
    if key.dim() != 1:
        raise ValueError(f"expected one key, got a batch {tuple(key.shape)}")
    k = key.tolist()
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def _key(w0: int, w1: int) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64)


def _batch_words(key: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    a = key.cpu().numpy().astype(np.int64) & MASK32
    return a[..., 0], a[..., 1]


def _batch_key(w0: np.ndarray, w1: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.stack([w0, w1], axis=-1)))


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 64-bit integer seed (as under
    `jax_enable_x64`): the words (seed >> 32, seed & 0xFFFFFFFF) of its
    two's-complement bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _key(seed >> 32, seed & MASK32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`, data taken as uint32.  One key and
    an int give one key; a [B..., 2] batch of keys and / or a sequence of
    ints broadcast against each other (the vmapped fold_in of the
    reference: keys [m, 2] with one int, or one key with m ints, give
    [m, 2])."""
    _check_key(key)
    if key.dim() == 1 and isinstance(data, (int, np.integer)):
        k1, k2 = _words(key)
        return _key(*threefry2x32(k1, k2, 0, int(data) & MASK32))
    k1, k2 = _batch_words(key)
    d = np.asarray(data, dtype=np.int64) & MASK32
    return _batch_key(*threefry2x32(k1, k2, np.zeros_like(d), d))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2] keys, hashes of the counters
    (0, i) (num < 2^32); a [B..., 2] batch gives [B..., num, 2] (the
    vmapped split)."""
    _check_key(key)
    if key.dim() == 1:
        k1, k2 = _words(key)
        return torch.stack([_key(*threefry2x32(k1, k2, 0, i)) for i in range(num)])
    k1, k2 = _batch_words(key)
    i = np.arange(num, dtype=np.int64)
    return _batch_key(*threefry2x32(k1[..., None], k2[..., None],
                                    np.zeros_like(i), i))


def _counters(shape: Sequence[int], device: torch.device):
    n = math.prod(int(d) for d in shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def _device_words(key: torch.Tensor, device: torch.device):
    """The words of a [B..., 2] key batch as [B, 1] int64 tensors on
    `device`: one host-to-device copy, from pinned memory so it does not
    wait for the device's queue."""
    w = host_to_device(key.reshape(-1, 2) & MASK32, device)
    return w[:, 0:1], w[:, 1:2]


def _bits_pair(key: torch.Tensor, shape: Sequence[int], device: torch.device,
               index: Optional[torch.Tensor] = None):
    """The two threefry output words of every counter of `shape`, each of
    shape [B..., *shape] for a key batch [B..., 2] (a single key: shape);
    with `index`, of the counters it holds (shape: its shape)."""
    _check_key(key)
    if index is None:
        shape = tuple(int(d) for d in shape)
        hi, lo = _counters(shape, device)
    else:
        shape = tuple(index.shape)
        idx = index.to(device=device, dtype=torch.int64).reshape(-1)
        hi, lo = idx >> 32, idx & MASK32
    if key.dim() == 1:
        k1, k2 = _words(key)
        b1, b2 = threefry2x32(k1, k2, hi, lo)
        return b1.reshape(shape), b2.reshape(shape)
    batch = tuple(key.shape[:-1])
    k1, k2 = _device_words(key, device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1.reshape(batch + shape), b2.reshape(batch + shape)


def random_bits(
    key: torch.Tensor, bit_width: int, shape: Sequence[int],
    device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.bits` words as int64 values of `shape` (a key batch
    [B..., 2] prepends B...): 32-bit draws in [0, 2^32); 64-bit draws as
    their two's-complement int64 bits."""
    if bit_width not in (32, 64):
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    device = resolve_device(device)
    b1, b2 = _bits_pair(key, shape, device)
    if bit_width == 32:
        return b1 ^ b2
    return (b1 << 32) | b2  # wraps into the sign bit, as a bit pattern


def uniform(
    key: torch.Tensor, shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float64, device: DeviceLike = None,
    minval: float = 0.0, maxval: float = 1.0, index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`, bit for bit,
    in f64 or f32 (a key batch [B..., 2] prepends B...): the [0, 1) draw f,
    then max(minval, f * (maxval - minval) + minval) with the bounds and
    their difference rounded to `dtype` and the multiply-add fused, as XLA
    computes it (`torch.addcmul`; the default [0, 1) skips that step: it is
    the identity).  JAX draws f64 when
    `jax_enable_x64` is on and no dtype is given, which is how every
    strategy of the repository draws.  `index` (int64, any shape) draws
    only the elements at those flat positions of a draw of `shape`, bit for
    bit its entries (each element hashes its own counter): a slice of a
    large draw without the rest of it."""
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"uniform draws float64 or float32, got {dtype}")
    device = resolve_device(device)
    b1, b2 = _bits_pair(key, shape, device, index)
    if dtype == torch.float64:
        # the top 52 of the 64 bits (b1 << 32 | b2) >> 12, from the words
        mant = (b1 << 20) | (b2 >> 12)
        f = mant.to(torch.float64) * 2.0 ** -52
    else:
        mant = (b1 ^ b2) >> 9
        f = mant.to(torch.float32) * 2.0 ** -23
    if minval == 0.0 and maxval == 1.0:
        return f
    npdt = np.float64 if dtype == torch.float64 else np.float32
    lo, hi = npdt(minval), npdt(maxval)
    scale = torch.full((), float(hi - lo), dtype=dtype, device=device)
    base = torch.full((), float(lo), dtype=dtype, device=device)
    return torch.clamp_min(torch.addcmul(base, f, scale), float(lo))


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


def _mulmod(a: torch.Tensor, c: int, s: int) -> torch.Tensor:
    """(a * c) mod s for int64 a in [0, 2^32), a Python int c in
    [0, 2^32) and s <= 2^32, with no product above 2^49."""
    t = (a * (c >> 16)) % s
    return (t * 65536 + a * (c & 0xFFFF)) % s


def _mul_low32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 (uint32 multiplication) for a, c in [0, 2^32)."""
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (hi + a * (c & 0xFFFF)) & MASK32


def randint(
    key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
    dtype: torch.dtype = torch.int64, device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, dtype)`, bit for bit,
    for int64 (JAX's default integer under x64: two 64-bit draws) and
    int32 (two 32-bit draws); a key batch [B..., 2] prepends B....

    JAX forms (hi mod span) * multiplier + (lo mod span), mod span, with
    multiplier = 2^nbits mod span, in unsigned nbits arithmetic (span = 1
    when maxval <= minval; one larger, possibly wrapping to 0, when maxval
    lies above the dtype's range).  Here every 64-bit word is reduced
    from its 32-bit halves, (h mod s) * (2^32 mod s) + (l mod s), and
    every product is taken in 16-bit pieces, so int64 holds it exactly.
    64-bit spans above 2^32 are not supported (ValueError)."""
    if dtype == torch.int64:
        nbits, lo_lim, hi_lim = 64, -(2 ** 63), 2 ** 63 - 1
    elif dtype == torch.int32:
        nbits, lo_lim, hi_lim = 32, -(2 ** 31), 2 ** 31 - 1
    else:
        raise not_ported(f"randint in {dtype}", "Queue 1 item 4")
    device = resolve_device(device)
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > hi_lim
    minc = min(max(minval, lo_lim), hi_lim)
    maxc = min(max(maxval, lo_lim), hi_lim)
    full = 1 << nbits
    span = (maxc - minc) % full
    if maxc <= minc:
        span = 1
    if out_of_range and maxc > minc:
        span = (span + 1) % full
    half = 1 << (nbits // 2)
    # XLA's unsigned remainder by zero is the dividend
    mult = half % span if span else half
    mult = (mult * mult) % full
    mult = mult % span if span else mult
    keys = split(key)
    k_hi, k_lo = keys[..., 0, :], keys[..., 1, :]
    h1, h2 = _bits_pair(k_hi, shape, device)
    l1, l2 = _bits_pair(k_lo, shape, device)
    if nbits == 32:
        hi, lo = h1 ^ h2, l1 ^ l2
        if span == 0:
            off = lo
        else:
            off = (_mul_low32(hi % span, mult) + lo % span) & MASK32
            off = off % span
        out = (minc + off + 2 ** 31) % 2 ** 32 - 2 ** 31
        return out.to(torch.int32)
    if span > 2 ** 32:
        raise ValueError(f"randint: 64-bit spans above 2^32 are not supported, "
                         f"got {span}")
    r32 = (1 << 32) % span
    hi = (_mulmod(h1 % span, r32, span) + h2 % span) % span
    lo = (_mulmod(l1 % span, r32, span) + l2 % span) % span
    off = (_mulmod(hi, mult, span) + lo) % span
    return minc + off


def permutation(
    key: torch.Tensor, x: Union[int, torch.Tensor], device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.permutation(key, x)` along axis 0, bit for bit: for an
    int n a shuffled arange(n) (int64, JAX's default integer under x64),
    for a tensor its rows in that order.  ceil(3 ln n / ln(2^32 - 1))
    rounds (two from n = 1,626), each a split, 32-bit sort keys and a
    stable sort.  `device` defaults to a tensor x's device.  For an int n a
    key batch [B..., 2] gives [B..., n], equal to stacking the single-key
    permutations (the vmapped permutation), in one pass."""
    _check_key(key)
    if isinstance(x, torch.Tensor):
        if key.dim() != 1:
            raise ValueError("permutation of a tensor takes one key")
        device = x.device if device is None else device
        n = int(x.shape[0])
    else:
        n = int(x)
    device = resolve_device(device)
    batch = tuple(key.shape[:-1])
    num_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    order = torch.arange(n, dtype=torch.int64, device=device).expand(batch + (n,))
    for _ in range(num_rounds):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        sort_keys = random_bits(sub, 32, (n,), device)
        order = torch.gather(order, -1, torch.sort(sort_keys, dim=-1, stable=True).indices)
    if isinstance(x, torch.Tensor):
        return x.to(device)[order]
    return order.contiguous()


#: XLA's erf_inv polynomials (the CHLO decomposition; jax 0.9 keeps a copy
#: at jax/_src/pallas/utils.py:200-293), coefficients from the highest
#: power down.  f32: one polynomial for w < 5 and one for w >= 5.
_ERF_INV_32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
#: f64: w < 6.25 (23 terms), 6.25 <= w < 16 (19), w >= 16 (17)
_ERF_INV_64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221),
)

_TABLES: dict = {}


def _coef_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """XLA's erf_inv coefficients as a [terms, branches] tensor of `dtype` on
    `device` (zero past a branch's last term), made once per (dtype,
    device)."""
    key = (dtype, str(device))
    if key not in _TABLES:
        rows = _ERF_INV_64 if dtype == torch.float64 else _ERF_INV_32
        n = max(len(r) for r in rows)
        table = [list(r) + [0.0] * (n - len(r)) for r in rows]
        _TABLES[key] = torch.tensor(table, dtype=dtype, device=device).T.contiguous()
    return _TABLES[key]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv of an f32 or f64 tensor (w = -log1p(-x^2), a
    polynomial in w - 2.5 / sqrt(w) - 3 (f32) or w - 3.125 / sqrt(w) -
    3.25 / sqrt(w) - 5 (f64), each step c + p * w; +-inf at |x| == 1).
    Each step is one fused multiply-add (`torch.addcmul`), as XLA fuses
    it, and each element's coefficient is gathered by its branch; as in
    XLA, the f64 polynomials of 19 and 17 terms stop early (the steps
    past a branch's last term leave p as it is)."""
    w = -torch.log1p(x * -x)
    table = _coef_table(x.dtype, x.device)
    if x.dtype == torch.float32:
        small = w < 5.0
        branch = (~small).long()
        w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
        p = table[0][branch]
        for i in range(1, 9):
            p = torch.addcmul(table[i][branch], p, w)
    else:
        lt625, lt16 = w < 6.25, w < 16.0
        branch = (~lt625).long() + (~lt16).long()
        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(w.dtype))
        p = table[0][branch]
        for i in range(1, 17):
            p = torch.addcmul(table[i][branch], p, w)
        for i in range(17, 19):
            p = torch.where(lt16, torch.addcmul(table[i][branch], p, w), p)
        for i in range(19, 23):
            p = torch.where(lt625, torch.addcmul(table[i][0], p, w), p)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(
    key: torch.Tensor, shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float64, device: DeviceLike = None,
) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` in f32 or f64 (a key batch
    [B..., 2] prepends B...): sqrt(2) * erf_inv(u), u uniform on
    (nextafter(-1, 0), 1) as max(lo, f * (1 - lo) + lo) of the [0, 1)
    uniform f, bit for bit; erf_inv as `erf_inv` above.  Within a few ulp
    of JAX's (torch's log1p is another implementation than XLA's);
    narrower dtypes are not ported."""
    if dtype not in (torch.float64, torch.float32):
        raise not_ported(f"normal draws in {dtype}", "Queue 1 item 4")
    npdt = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(npdt(-1.0), npdt(0.0)))
    u = uniform(key, shape, dtype, device, lo, 1.0)
    return erf_inv(u) * float(npdt(np.sqrt(2.0)))
