"""Unsigned 32-bit arithmetic on int64 tensors.

PyTorch on the CPU implements few operators for ``torch.uint32``
(``<``, ``>>``, ``min``, ``where``, ``topk`` and ``searchsorted`` all
raise), so the port holds every u32 quantity as ``torch.int64`` in
``0 .. 2**32 - 1``.  Order, equality, XOR, AND, OR and right shifts are
then exact as they stand; a LEFT shift must be masked back to 32 bits
(:func:`shl32`), and an int32 bitcast of a u32 value goes through
:func:`as_i32` / :func:`as_u32`.
"""

from __future__ import annotations

from typing import Sequence

import torch

MASK32 = 0xFFFFFFFF
U32_MAX = MASK32


def shl32(x: torch.Tensor, s) -> torch.Tensor:
    """``(x << s) mod 2**32`` for ``x`` in u32 range and ``0 <= s < 32``."""
    return (x << s) & MASK32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 values as u32, held in int64 (``-1 → 2**32-1``)."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret u32 values (int64) as int32 — the bitcast
    ``lax.bitcast_convert_type(x, int32)``."""
    # graftlint: disable=narrow-cast-unproven (the u32 -> int32 bitcast: each branch of the where lies in [-2^31, 2^31 - 1] (x >= 2^31 takes x - 2^32), which an interval join of the branches cannot see)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def prefix_len32(d0: torch.Tensor) -> torch.Tensor:
    """Leading-zero count of u32 values, 32 where zero (int64).

    An exact shift chain: PyTorch has no ``clz``, and ``log2`` in
    floating point rounds values near ``2**32`` up a whole bit."""
    x = d0
    n = torch.zeros_like(d0)
    for s in (16, 8, 4, 2, 1):
        top_clear = x < (1 << (32 - s))
        n = n + top_clear.to(torch.int64) * s
        x = torch.where(top_clear, shl32(x, s), x)
    return torch.where(d0 == 0, torch.full_like(n, 32), n)


def lexsort(keys: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Stable lexicographic sort permutation along ``dim``.

    ``keys[0]`` is the most significant key.  Built from LSD passes of
    ``torch.sort(stable=True)`` — the counterpart of
    ``lax.sort(..., num_keys=len(keys), is_stable=True)``: equal key
    tuples keep their input order."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, dim, perm)
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        _, p = torch.sort(k, dim=dim, stable=True)
        perm = p if perm is None else torch.gather(perm, dim, p)
    return perm


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in u32 range and a constant ``c``
    in u32 range, without an int64 overflow: ``c`` is split into 16-bit
    halves, so every partial product stays below ``2**48``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32
