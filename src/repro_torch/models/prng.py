"""JAX's threefry2x32 key schedule and the samplers built on it, in torch
integer ops (the reference draws with `jax.random`, which has no module
in the JAX package; this is the recipe of jax 0.9's `_src/prng.py` and
`_src/random.py` under `jax_threefry_partitionable=True`, its default).

A key is the raw key data: an int64 tensor (..., 2) holding two uint32
words.  torch.uint32 has no add or shift on the CPU, so every word is
held in int64 and masked to 32 bits after each add and shift; the bits,
keys (`fold_in`, `split`) and uniforms equal JAX's bit for bit.  `gumbel`
takes two logs, whose last bit may differ from XLA's by an ulp (and
CUDA's `logf` from both), so `categorical` gives JAX's token except at an
exact tie of noise plus logits in fp32.  `normal` is XLA's own
single-precision `erf_inv` polynomial, within a few ulps of JAX's (its
`log1p` is not XLA's).  Every op runs on the device of its inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k0, k1); every argument an int64 tensor of uint32
    words, broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`'s raw key (2,): the seed's high and
    low 32 bits."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` over a batch: keys (..., 2), data (...)
    integers (a tensor, or a Python int for every key) taken mod 2^32 ->
    keys (..., 2).  The data is hashed as the counter pair (0, data), its
    threefry seed.  An int is filled on the keys' device: no host copy."""
    if isinstance(data, int):
        data = torch.full(keys.shape[:-1], data & M32, dtype=torch.int64,
                          device=keys.device)
    d = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)` for each key: keys (..., 2) -> (..., n,
    2).  The partitionable layout: key i is the hash of the counter pair
    (i >> 32, i & M32), both output words (so it equals fold_in(key, i))."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    y0, y1 = threefry2x32(keys[..., 0].reshape(lead + (1,)),
                          keys[..., 1].reshape(lead + (1,)), idx >> 32,
                          idx & M32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)` for each key: keys (..., 2)
    -> (..., *shape) uint32 words in int64.  The partitionable layout:
    element i (row-major) hashes the counter pair (i >> 32, i & M32) and
    is the xor of the two output words."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,))
    k1 = keys[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (y0 ^ y1).reshape(lead + shape)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """fp32 `jax.random.uniform(key, shape, minval=, maxval=)` for each
    key: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval) and clamped below at minval."""
    bits = random_bits(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """fp32 `jax.random.gumbel(key, shape)` (its default mode "low"):
    -log(-log(u)) with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` for each row: keys (T, 2),
    logits (T, V) fp32 -> (T,) int64, the argmax of gumbel noise plus
    logits (the lowest id at a tie)."""
    g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


# XLA's single-precision erf_inv (Giles' polynomial): coefficients for
# w = -log1p(-x^2) < 5 and for w >= 5, highest degree first
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """fp32 inverse error function as XLA computes it: w = -log1p(-x*x),
    a 9-term Horner in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at
    |x| = 1.  Each Horner step c + p*w is rounded once to fp32 from its
    exact fp64 value, as XLA's fused multiply-add rounds it (separate fp32
    ops part from JAX on 5 % of values instead of 1 %)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERF_INV_LT5[0], _ERF_INV_GE5[0])
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        c = torch.where(lt, a, b)
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """fp32 `jax.random.normal(key, shape)` for each key: sqrt(2) *
    erf_inv(u) with u uniform in [nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(keys, shape, lo, 1.0)
    return torch.full((), 2.0 ** 0.5, dtype=torch.float32,
                      device=keys.device) * erf_inv(u)
