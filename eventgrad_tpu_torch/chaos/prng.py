"""The counter-based random draws of the fault schedules, on the host.

The port's own copy of what the fault clauses need of JAX's default
PRNG (`jax._src.prng`, `jax._src.random`, with
`jax_threefry_partitionable=True`): the Threefry-2x32 hash, `PRNGKey`,
`fold_in`, `split`, `uniform` (float32 in [0, 1)) and `randint`, in
numpy `uint32` arithmetic, bit for bit what `jax.random` returns for the
same key. Every function is vectorised over arrays of keys: a key is a
pair `(k1, k2)` of `uint32` arrays of one shape, and a draw of shape `s`
from keys of shape `K` has shape `K + s`. The schedules fold the pass
and the receiving rank into the key, so one call draws a whole table
(`chaos.inject.delivery_table`).

`threefry_partitionable(False)` (a context) switches `split`,
`random_bits` and the draws built on them to JAX's other counter layout,
`jax_threefry_partitionable=False` (the original `_threefry_split` and
`_threefry_random_bits`: one iota of counters halved into the two hash
lanes). It was JAX's default before the partitionable layout, and the
JAX package's committed chaos and integrity artifacts were drawn with
it; `fold_in` and `PRNGKey` are the same in both.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np

Key = Tuple[np.ndarray, np.ndarray]

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

#: the counter layout of `split` and `random_bits` (JAX's
#: `jax_threefry_partitionable`, True in the JAX the port is held to)
_PARTITIONABLE = [True]


@contextlib.contextmanager
def threefry_partitionable(on: bool):
    """Draw with JAX's partitionable counter layout (`on`, the default)
    or its original one inside the block."""
    was = _PARTITIONABLE[0]
    _PARTITIONABLE[0] = bool(on)
    try:
        yield
    finally:
        _PARTITIONABLE[0] = was


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).astype(_U32) if not (
        isinstance(x, np.ndarray) and x.dtype == _U32) else x


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the keys (k1, k2), all `uint32`, broadcast together: the
    unrolled lowering of `jax._src.prng._threefry2x32_lowering`."""
    k1, k2, x1, x2 = np.broadcast_arrays(_u32(k1), _u32(k2), _u32(x1),
                                         _u32(x2))
    with np.errstate(over="ignore"):
        ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^31): the pair
    (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return np.zeros((), _U32), np.asarray(seed, _U32)


def fold_in(key: Key, data) -> Key:
    """`jax.random.fold_in(key, data)`: the hash of the counter pair
    (0, data) under `key`; `data` (non-negative integers) broadcasts
    against the key's shape."""
    return threefry2x32(key[0], key[1], 0, data)


def _hash_iota(key: Key, m: int) -> np.ndarray:
    """The original layout's `threefry_2x32(key, iota(m))`: the counters
    (zero-padded to even length) halved into the two lanes, the two
    output lanes concatenated; shape `key shape + (m,)`."""
    k1 = np.asarray(key[0])[..., None]
    k2 = np.asarray(key[1])[..., None]
    cnt = np.zeros(m + m % 2, _U32)
    cnt[:m] = np.arange(m, dtype=_U32)
    half = len(cnt) // 2
    y1, y2 = threefry2x32(k1, k2, cnt[:half], cnt[half:])
    return np.concatenate([y1, y2], axis=-1)[..., :m]


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """`jax.random.split(key, num)`: in the partitionable layout subkey i
    is the hash of the counter pair (0, i); in the original one the hash
    of `iota(2 num)`, read as num pairs."""
    if _PARTITIONABLE[0]:
        return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(num))
    words = _hash_iota(key, 2 * num)
    return tuple((words[..., 2 * i], words[..., 2 * i + 1])
                 for i in range(num))


def random_bits(key: Key, n: int) -> np.ndarray:
    """32-bit random words of shape `key shape + (n,)`: in the
    partitionable layout the hash of the counter pairs (0, i), i < n, its
    two lanes xored; in the original one `threefry_2x32(key, iota(n))`."""
    if not _PARTITIONABLE[0]:
        return _hash_iota(key, n)
    k1 = np.asarray(key[0])[..., None]
    k2 = np.asarray(key[1])[..., None]
    b1, b2 = threefry2x32(k1, k2, 0, np.arange(n, dtype=_U32))
    return b1 ^ b2


def uniform(key: Key, n: int) -> np.ndarray:
    """`jax.random.uniform(key, (n,))`: float32 in [0, 1) from the top 23
    bits of each word, as the mantissa of a number in [1, 2) less 1."""
    bits = random_bits(key, n)
    one = np.asarray(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats)


def randint(key: Key, n: int, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, (n,), minval, maxval)` (int32): two words
    a value from the split key, folded into the span with the 2^32
    multiplier's remainder, in wrapping uint32 arithmetic."""
    minval, maxval = int(minval), int(maxval)
    span = _U32(max(maxval - minval, 1) if maxval > minval else 1)
    k_hi, k_lo = split(key)
    hi, lo = random_bits(k_hi, n), random_bits(k_lo, n)
    with np.errstate(over="ignore"):
        mult = _U32(2**16) % span
        mult = (mult * mult) % span
        off = (hi % span) * mult + (lo % span)
        off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
