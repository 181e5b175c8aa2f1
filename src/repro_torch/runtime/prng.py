"""Threefry-2x32 counter-based random bits as torch integer ops.

The reference draws the token at sequence index ``pos`` of a request with
``jax.random.fold_in(jax.random.PRNGKey(seed), pos)`` and one
``jax.random.uniform(key, ())``.  Reproducing those bits exactly is what
lets the port's sampled streams — not only greedy ones — be held against
the reference token for token.  This module implements the same
functions, bit for bit, for JAX's default configuration
(``jax_threefry_partitionable=True``: a scalar draw is the XOR of both
Threefry output words at counter (0, 0)).

The speculative backend also needs ``split`` and shaped draws
(``random_bits``, ``uniform_shaped``, ``gumbel``, ``categorical``): with
the partitionable Threefry, element i of a shaped draw (row-major flat
index) is Threefry at counter (0, i), and ``split(key, n)`` gives key i as
the two output words at counter (0, i).

Keys are int64 tensors of shape ``(..., 2)`` holding two uint32 words;
every operation is vectorised over the leading dims and runs on any
device.  uint32 arithmetic is emulated in int64 with a 32-bit mask.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block function on uint32 words (int64
    tensors, broadcast together); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for non-negative integer seeds:
    the words (seed >> 32, seed & 0xFFFFFFFF)."""
    s = seed.long()
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: Threefry of the counter
    (0, uint32(data)) under ``key``."""
    d = data.long() & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, ())`` per key: f32 in [0, 1) from the top
    23 bits of one 32-bit draw."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0, 0.0)


def token_key(seed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The key of the token at sequence index ``pos`` of stream ``seed`` —
    the whole reproducibility invariant lives here."""
    return fold_in(prng_key(seed), pos)


def _counter_bits(key: torch.Tensor, n: int):
    """Both Threefry output words at counters (0, i), i < n, for one key
    (shape (2,)): the partitionable stream of a flat draw of n elements."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key: (num, 2) keys."""
    y0, y1 = _counter_bits(key, num)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32), as
    ``jax.random.bits(key, shape)``: the XOR of both words at counter
    (0, flat index)."""
    n = 1
    for d in shape:
        n *= int(d)
    y0, y1 = _counter_bits(key, n)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform_shaped(key: torch.Tensor, shape, minval: float = 0.0,
                   maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in f32: the top
    23 bits as a mantissa in [1, 2), minus 1, times the f32 span, plus
    minval, clamped below at minval (the same f32 ops; the bounds enter as
    scalars, so nothing is copied to the key's device)."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    bits = random_bits(key, shape) >> 9 | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (f32, the default "low" mode):
    -log(-log(u)) of a uniform on [tiny, 1).  The uniform is bit-equal to
    jax's; the two logs are each framework's own, so a value may differ
    from jax's in its last bits."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform_shaped(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw, argmax(logits + gumbel) over the last axis (the first index on a
    tie, as jax's)."""
    g = gumbel(key, tuple(logits.shape)).to(logits.device)
    return torch.argmax(logits.float() + g, dim=-1)
