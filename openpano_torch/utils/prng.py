"""Threefry-2x32 counter-based keys that give the JAX package's random bits.

RANSAC draws its hypotheses from ``jax.random`` in the JAX package
(``geometry/ransac.py:91``), with keys split per original pair slot
(``stitch/stitcher.py:150``).  To draw the same hypotheses, this module
re-implements the three pieces that path uses, bit for bit:

- ``threefry2x32``: the Threefry-2x32 hash (20 rounds), as in
  ``jax._src.prng._threefry2x32_lowering``;
- ``split``: ``jax.random.split`` under ``jax_threefry_partitionable``
  (the default): subkey i is the hash of the 64-bit counter i;
- ``uniform_f64``: ``jax.random.uniform`` for float64 (the JAX package runs
  with x64 on, so its default float is 64-bit): the hash of counter i gives
  a 64-bit word ``hi << 32 | lo``; its top 52 bits are the mantissa of a
  float in [1, 2), minus 1.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  All
arithmetic is on int64 tensors masked to 32 bits, so it runs the same on
the CPU and on the card.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed_pair=(0, 0), device=None) -> torch.Tensor:
    """A key from its two uint32 words (``PRNGKey(s)`` is ``(s >> 32, s & M)``
    for a 64-bit seed s; ``PRNGKey(0)`` is ``(0, 0)``)."""
    k0, k1 = (int(v) & _M32 for v in seed_pair)
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) under key (k0, k1); all
    int64 tensors of uint32 values that broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counter(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(k, num)``: [num, 2] subkeys."""
    hi, lo = _counter(num, k.device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def uniform_f64(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` with float64 as the default dtype:
    [*shape] float64 in [0, 1).  ``k`` may carry leading batch dims
    ([..., 2]); the result is then [..., *shape], one draw per key."""
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counter(n, k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    # top 52 bits of (b0 << 32 | b1), as an exact integer below 2**52
    mant = (b0 << 20) | (b1 >> 12)
    return (mant.to(torch.float64) * 2.0 ** -52).reshape(*lead, *shape)
