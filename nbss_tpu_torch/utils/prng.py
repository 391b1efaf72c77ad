"""``jax.random``'s threefry2x32 generator in PyTorch.

The same bits as ``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable``
on, its default) for ``PRNGKey``, ``split``, ``fold_in``, raw bits,
``uniform``, ``normal`` and ``randint``, so that a mixture drawn from a key
here equals the one the JAX package draws from the same key.

A key is an int64 tensor [..., 2] holding two uint32 words; every function
takes a batch of keys in the leading dimensions and draws for each key what
``jax.vmap`` of the JAX function would. The words live in int64 masked to 32
bits because CUDA lacks most uint32 operations, so this runs on any device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under
    the key (k1, k2); every argument an int64 tensor of uint32 values, all
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in int32's range: [0, seed mod 2**32]."""
    if not -(2 ** 31) <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32's range")
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, each [..., 1 x ndim] to broadcast over a draw."""
    k = key.reshape(*key.shape[:-1], *([1] * ndim), 2)
    return k[..., 0], k[..., 1]


def _counts(shape: tuple, device) -> torch.Tensor:
    """The low words of a flat uint64 iota over ``shape`` (the high words are
    0 below 2**32 elements)."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("draws of 2**32 elements or more")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys [..., 2] -> [..., *num, 2]."""
    shape = _shape(num)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, torch.zeros((), dtype=torch.int64, device=key.device),
                          _counts(shape, key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] and int data broadcastable to
    [...] (taken mod 2**32, as JAX casts it to uint32) -> keys [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros((), dtype=torch.int64, device=key.device), data)
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits per element: keys [..., 2] -> int64 [..., *shape] in [0, 2**32)."""
    shape = _shape(shape)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, torch.zeros((), dtype=torch.int64, device=key.device),
                          _counts(shape, key.device))
    return b1 ^ b2


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: [..., *shape] in [minval, maxval).
    ``minval``/``maxval`` are numbers or float32 tensors broadcastable to
    [..., *shape]; both are cast to float32 before their difference, as in JAX.
    The scaling is one fused multiply-add, as XLA compiles it: the float32
    product is exact in float64, so the sum rounds once to float32 there."""
    shape = _shape(shape)
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    b = bits(key, shape)
    one = (b >> 9) | 0x3F800000  # random mantissa under the exponent of 1.0
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's single-precision erf_inv (M. Giles, "Approximating the erfinv
# function"): a polynomial in w = -log1p(-x^2), one for w < 5, one above
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 by XLA's polynomial and its fused multiply-adds, so
    normals match JAX's to an ulp (``torch.erfinv`` is 40 ulps off in the
    tails); the two may still differ where their log1p does."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    w = w.double()
    p = torch.where(small, _f32(_ERFINV_SMALL[0], x.device), _f32(_ERFINV_LARGE[0], x.device))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):  # Horner by fused multiply-adds
        c = torch.where(small, _f32(cs, x.device), _f32(cl, x.device))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erf^-1(u), u uniform in
    [nextafter(-1, 0), 1)."""
    return _SQRT2 * erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def randint(key: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` for int32: [..., *shape] in [minval, maxval)
    (int64 tensors of int32 values). Two 32-bit draws from the key's two
    halves are combined modulo the span, as JAX's ``_randint`` does, with
    its uint32 wrap-around; exact for spans below 2**31."""
    shape = _shape(shape)
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev).clamp(-(2 ** 31), 2 ** 31 - 1)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev).clamp(-(2 ** 31), 2 ** 31 - 1)
    k = split(key, 2)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK)
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span  # uint32 products wrap
    offset = (((higher % span) * multiplier) & MASK) + lower % span
    offset = (offset & MASK) % span
    out = (lo + offset) & MASK  # int32 wrap-around, as JAX's convert_element_type
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)
