"""Threefry-2x32 in torch integer ops: the seeding contract of the
on-device env family (:mod:`.jax_envs`), reproduced bit for bit.

The JAX package derives everything procedural about an env from
``jax.random`` keys: env ``i`` of a batch is seeded with
``fold_in(key, i)``, episode ``e`` of an env draws its content from
``fold_in(key, e)`` through ``randint`` (and ``split`` first, for the
procedural variant).  torch's Philox cannot reproduce those draws, so this
module writes the derivation out in integer ops, as ``jax.random`` computes
it with ``jax_threefry_partitionable`` on (the default from jax 0.5):

- ``threefry2x32(k, (c_hi, c_lo))``: 20 rounds of add / rotate / xor over
  a pair of 32-bit words, the key injected every 4 rounds;
- ``fold_in(k, d) = threefry2x32(k, (0, d))``;
- ``split(k, n)[i] = threefry2x32(k, (0, i))`` (the partitionable,
  fold-like split);
- 32 random bits of a scalar draw: ``y0 ^ y1`` of ``threefry2x32(k, (0, 0))``;
- ``randint(k, lo, hi)``: two such draws from ``split(k, 2)``, folded
  through the span ``hi - lo`` and jax's multiplier ``(2**16 mod
  span)**2 mod 2**32 mod span`` in wrapping uint32 arithmetic, then
  offset by ``lo`` (a negative ``lo`` works).

A key is a tensor ``[..., 2]`` of raw uint32 words held in int64 (torch's
uint32 ops are incomplete on CUDA): every value stays in ``[0, 2**32)``,
masked after each add and rotate.  Every function takes any batch shape
and runs on the key's device, CPU or CUDA alike, with no host sync.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Int = Union[int, torch.Tensor]


def _rounds(x0: torch.Tensor, x1: torch.Tensor, rotations) -> Tuple[torch.Tensor, torch.Tensor]:
    for r in rotations:
        # x1 enters clean (< 2**32), so its right shift is exact; the sum
        # and the left shift may carry junk above bit 31, which the mask
        # after the xor removes (x0 is masked with the key injection).
        x0 = x0 + x1
        x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK
    return x0, x1


def threefry2x32(key: torch.Tensor, x0: Int, x1: Int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)`` under
    ``key`` ``[..., 2]``; ``x0``/``x1`` broadcast against ``key[..., 0]``.
    Returns the two output words, int64 in ``[0, 2**32)``."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROTATIONS[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def seed(value: int, device=None) -> torch.Tensor:
    """``jax.random.key(value)`` as raw words ``[2]``: the high and low 32
    bits of a non-negative seed below ``2**64``."""
    value = int(value)
    if not 0 <= value < 2 ** 64:
        raise ValueError(f"seed {value} is not in [0, 2**64)")
    return torch.tensor([value >> 32, value & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Int) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` ``[..., 2]``, ``data`` an int or an
    integer tensor broadcastable to ``key[..., 0]`` (taken mod ``2**32``,
    as jax casts it to uint32).  Returns ``[..., 2]``."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y0, y1 = threefry2x32(key, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``[..., 2]`` → ``[..., num, 2]``
    (for one key ``[2]``, ``[num, 2]`` as in jax)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], 0, counts)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor) -> torch.Tensor:
    """32 random bits of one scalar draw per key (``jax.random.bits`` of
    shape ``()``, uint32): ``[..., 2]`` → ``[...]`` in ``[0, 2**32)``."""
    y0, y1 = threefry2x32(key, 0, 0)
    return y0 ^ y1


def randint_from_bits(bits: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """The fold of ``randint``: ``bits`` ``[..., 2]`` (the high and the low
    draw) → int64 ``[...]`` in ``[minval, maxval)``, in jax's wrapping
    uint32 arithmetic.  The bounds are Python ints within int32, folded on
    the host (no tensor is built per call)."""
    minval, maxval = int(minval), int(maxval)
    # Span 1 when maxval <= minval, so minval is returned (jax's rule).
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    multiplier = ((((2 ** 16) % span) ** 2) & MASK) % span
    hi, lo = bits[..., 0], bits[..., 1]
    offset = (((hi % span) * multiplier) & MASK) + lo % span
    return minval + (offset & MASK) % span


def randint(key: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (), minval, maxval, jnp.int32)`` per key:
    ``[..., 2]`` → int64 ``[...]``: the two draws of ``split(key, 2)``
    through :func:`randint_from_bits`."""
    return randint_from_bits(random_bits(split(key, 2)), minval, maxval)


__all__ = ["MASK", "fold_in", "randint", "randint_from_bits", "random_bits", "seed", "split",
           "threefry2x32"]
