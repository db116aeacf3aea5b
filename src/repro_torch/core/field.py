"""Finite-algebra substrate: the ring Z_2^32 and the field F_{2^31-1}.

Counterpart of ``repro/core/field.py``.  A 32-bit word is carried in
one of two ways:

* ``int64`` holding the unsigned value in ``[0, 2^32)`` — what the plain
  versions compute with, on any device (the CPU build of torch has no
  add, shift, compare or sum for ``torch.uint32``);
* ``int32`` holding the same bit pattern — what the CUDA kernels read
  and write on the card.

``u32`` turns either into the first, ``to_i32`` the first into the
second.  Every function here takes and returns ``int64`` words and is
exact: a product of two field elements (< 2^62) fits in ``int64``, and
``mulhilo32`` splits one operand into 16-bit halves so that no partial
product passes 2^48.
"""

from __future__ import annotations

import torch

MERSENNE_P = 0x7FFFFFFF
U32_MASK = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """Words as ``int64`` values in ``[0, 2^32)`` (from int32 bits too)."""
    x = torch.as_tensor(x)
    if x.dtype != torch.int64:
        x = x.to(torch.int64)
    return x & U32_MASK


def to_i32(x) -> torch.Tensor:
    """``int64`` words in ``[0, 2^32)`` -> ``int32`` with the same bits."""
    x = u32(x)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def words_like(x64: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``int64`` words in the carrier of ``like`` (int32 or int64)."""
    return to_i32(x64) if like.dtype == torch.int32 else x64


# ---------------------------------------------------------------------------
# 32x32 -> 64 bit multiply
# ---------------------------------------------------------------------------

def mulhilo32(a, b):
    """Full 64-bit product of two words as a ``(hi, lo)`` pair.

    ``b`` is split into 16-bit halves; ``a * b_lo`` and ``a * b_hi`` are
    below 2^48, and the carry is folded through ``mid``.
    """
    a = u32(a)
    b = u32(b)
    t0 = a * (b & 0xFFFF)
    t1 = a * (b >> 16)
    mid = (t0 >> 16) + t1
    lo = ((mid & 0xFFFF) << 16) | (t0 & 0xFFFF)
    hi = mid >> 16
    return hi, lo


def mullo32(a, b):
    """Low 32 bits of the product (ring multiply)."""
    return mulhilo32(a, b)[1]


# ---------------------------------------------------------------------------
# Ring Z_2^32
# ---------------------------------------------------------------------------

def ring_add(a, b):
    return (u32(a) + u32(b)) & U32_MASK


def ring_sub(a, b):
    return (u32(a) - u32(b)) & U32_MASK


def ring_neg(a):
    return (-u32(a)) & U32_MASK


def ring_sum(x, axis=0):
    """Wrap-around sum along ``axis`` (exact below 2^31 terms)."""
    return u32(x).sum(dim=axis) & U32_MASK


# ---------------------------------------------------------------------------
# Mersenne-31 field F_p, p = 2^31 - 1
# ---------------------------------------------------------------------------

def mersenne_reduce(x):
    """A word in ``[0, 2^32)`` reduced to ``[0, p)``."""
    x = u32(x)
    t = (x & MERSENNE_P) + (x >> 31)
    return torch.where(t >= MERSENNE_P, t - MERSENNE_P, t)


def fadd(a, b):
    """Field add of operands in ``[0, p)``."""
    return mersenne_reduce(u32(a) + u32(b))


def fsub(a, b):
    a = u32(a)
    b = u32(b)
    return torch.where(a >= b, a - b, a + MERSENNE_P - b)


def fneg(a):
    a = u32(a)
    return torch.where(a == 0, a, MERSENNE_P - a)


def fmul(a, b):
    """Field multiply of operands in ``[0, p)``: the product fits int64."""
    return (u32(a) * u32(b)) % MERSENNE_P


def fsum(x, axis=0):
    """Field sum along ``axis``, one ``fadd`` per term."""
    x = u32(x).movedim(axis, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = fadd(acc, x[i])
    return acc


def to_field(x):
    """Any word -> ``[0, p)``: mask to 31 bits, fold ``p`` to 0."""
    r = u32(x) & MERSENNE_P
    return torch.where(r == MERSENNE_P, torch.zeros_like(r), r)
