"""Feldman verifiable secret sharing for the Shamir scheme (§10).

Counterpart of ``repro/core/vss.py``.  A dealer publishes commitments
``C_j = h^{a_j}`` to the coefficients of its Shamir polynomial, and any
verifier checks a share ``s_w = q(x_w)`` — or a committee member's
partial sum, against the product of all dealers' commitments — by

    h^{s_w}  ==  Π_j C_j^{x_w^j}          (in the group <h>)

The group is the order-``p`` subgroup of ``F_q^*`` with
``q = 2^59 - 2^28 + 1 = 2^28 * p + 1`` and ``p = 2^31 - 1`` the Shamir
field, generated by ``h = 3^(2^28) mod q``.

Carriers: a group element is one ``int64`` value in ``[0, q)`` (the
reference's two ``uint32`` limbs in one word).  Commitments travel in
the reference's wire layout, ``[..., degree+1, 2]`` words ``(hi, lo)``
(``pack``/``unpack``), as ``int64`` words or, for the CUDA kernel,
``int32`` bit patterns (``core.field``).  Every function returns
canonical residues in ``[0, q)``, so the bits equal the reference's
whatever the order of the products: ``qmul`` reduces a product exactly
with 30-bit halves and ``2^59 ≡ 2^28 - 1 (mod q)``, and ``gpow`` reads
four byte-indexed tables of powers of ``h`` instead of the reference's
31-step ladder (the CUDA kernel keeps the ladder, ``csrc/fq.cuh``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import philox
from .field import MERSENNE_P, U32_MASK, to_field, u32

__all__ = [
    "VSS_GEN_INT", "VSS_ORDER_INT", "VSS_Q_INT", "aggregate_commits",
    "commit_elements", "commit_elems", "feldman_commit", "gpow",
    "np_commit", "np_verify_share", "pack", "product", "qadd", "qmul",
    "qpow_scalar", "to_int", "unpack", "verify_share",
]

#: Commitment-group modulus: prime with ``q - 1 = 2^28 * (2^31 - 1)``.
VSS_Q_INT = 2**59 - 2**28 + 1
#: Order of the commitment subgroup — the Shamir field modulus.
VSS_ORDER_INT = MERSENNE_P
#: Generator of the order-p subgroup: ``3^(2^28) mod q``.
VSS_GEN_INT = pow(3, 2**28, VSS_Q_INT)
assert pow(VSS_GEN_INT, VSS_ORDER_INT, VSS_Q_INT) == 1
assert VSS_GEN_INT != 1

#: ``2^59 ≡ 2^28 - 1 (mod q)``: the Crandall fold
_T28 = (1 << 28) - 1
_M29 = (1 << 29) - 1
_M30 = (1 << 30) - 1

#: Fixed-base table ``h^(2^i)`` for i = 0..30 as ``(hi, lo)`` words:
#: exponents are field elements below ``2^31``.  The CUDA kernel's
#: ``kGenPow`` (``kernels/csrc/verify_shares.cu``) holds the same values.
_GEN_POW = np.array(
    [[(pow(VSS_GEN_INT, 1 << i, VSS_Q_INT) >> 32) & U32_MASK,
      pow(VSS_GEN_INT, 1 << i, VSS_Q_INT) & U32_MASK]
     for i in range(31)], dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _byte_tables(device: torch.device) -> torch.Tensor:
    """``h^(b * 256^i)`` at flat index ``256 i + b`` (i < 4, b < 256),
    on ``device``: ``gpow`` is four lookups and three products."""
    vals = [pow(VSS_GEN_INT, b << (8 * i), VSS_Q_INT)
            for i in range(4) for b in range(256)]
    return torch.tensor(vals, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# F_q arithmetic on int64 elements in [0, q)
# ---------------------------------------------------------------------------

def _elements(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.dtype == torch.int64 else x.to(torch.int64)


def qadd(a, b):
    """``(a + b) mod q`` of elements in ``[0, q)``."""
    s = _elements(a) + _elements(b)
    return torch.where(s >= VSS_Q_INT, s - VSS_Q_INT, s)


def _shift30(x):
    """``x * 2^30 mod q`` up to one more reduction: below ``2^60``."""
    return ((x & _M29) << 30) + (x >> 29) * _T28


def qmul(a, b):
    """``(a * b) mod q`` of elements in ``[0, q)``.

    With 30-bit halves ``a = a1 2^30 + a0`` the product is
    ``p2 2^60 + p1 2^30 + p0`` with every partial product below
    ``2^60``; Horner in base ``2^30`` keeps each step below ``2^61``.
    """
    a = _elements(a)
    b = _elements(b)
    a0, a1 = a & _M30, a >> 30
    b0, b1 = b & _M30, b >> 30
    r = (a1 * b1) % VSS_Q_INT
    r = (_shift30(r) + a0 * b1 + a1 * b0) % VSS_Q_INT
    return (_shift30(r) + a0 * b0) % VSS_Q_INT


def qpow_scalar(a, e: int):
    """``a^e mod q`` for a host Python-int exponent."""
    e = int(e)
    if e < 0:
        raise ValueError(f"exponent must be non-negative, got {e}")
    a = _elements(a)
    r = None
    base = a
    while e > 0:
        if e & 1:
            r = base if r is None else qmul(r, base)
        e >>= 1
        if e:
            base = qmul(base, base)
    return torch.ones_like(a) if r is None else r


def gpow(exponent):
    """Fixed-base ``h^s`` for words ``s``; the low 31 bits are used, as
    the reference's ladder uses them (exponents are field elements)."""
    s = u32(exponent) & MERSENNE_P
    table = _byte_tables(s.device)
    t = [table[((s >> (8 * i)) & 0xFF) + 256 * i] for i in range(4)]
    return qmul(qmul(t[0], t[1]), qmul(t[2], t[3]))


def product(x, dim: int = 0):
    """Product mod q along ``dim``, pairwise (any order gives the same
    canonical residue)."""
    x = _elements(x).movedim(dim, 0)
    if x.shape[0] == 0:
        raise ValueError("product of an empty axis")
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = qmul(x[:h], x[h:2 * h])
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def pack(x):
    """Elements ``[...]`` -> ``int64`` words ``[..., 2]`` ``(hi, lo)``,
    the wire layout."""
    x = _elements(x)
    return torch.stack([x >> 32, x & U32_MASK], dim=-1)


def unpack(packed):
    """Words ``[..., 2]`` ``(hi, lo)`` (``int64`` or ``int32`` bits) ->
    elements ``[...]``."""
    w = u32(packed)
    return (w[..., 0] << 32) | w[..., 1]


# ---------------------------------------------------------------------------
# Feldman commit / verify
# ---------------------------------------------------------------------------

def commit_elems(d: int, degree: int) -> int:
    """Words one dealer's commitment message carries: ``[d, degree+1,
    2]``, element-major, so a chunk of codeword elements is a
    contiguous word range of the message."""
    return d * (degree + 1) * 2


def commit_elements(v, key0, key1, degree: int, counter_base: int = 0):
    """``h^{a_j}`` as elements ``[*v.shape, degree+1]``.

    ``a_0 = v`` (field codewords ``[*B, D]``) and ``a_1..a_d`` are drawn
    from the keyed Philox streams exactly as ``core.shamir.share`` draws
    them (``counter_hi = j+1``, the same ``counter_base``), so chunked
    commitments are slices of the whole-vector ones.  ``key0``/``key1``
    are ints or ``int64`` words of shape ``B``.
    """
    v = u32(v)
    n = v.shape[-1]
    coeffs = [v] + [
        to_field(philox.random_bits(n, key0, key1, counter_hi=j + 1,
                                    counter_base=counter_base,
                                    device=v.device).expand(v.shape))
        for j in range(degree)]
    return torch.stack([gpow(a) for a in coeffs], dim=-1)


def feldman_commit(v, key0, key1, degree: int, counter_base: int = 0):
    """Commit to the Shamir polynomial of ``core.shamir.share``: words
    ``[*v.shape, degree+1, 2]`` (``C_j = h^{a_j}``, element-major)."""
    return pack(commit_elements(v, key0, key1, degree, counter_base))


def aggregate_commits(commits):
    """Pointwise product of dealers' commitments: words
    ``[l, ..., k, 2] -> [..., k, 2]`` — commits to the sum polynomial,
    which member partial sums verify against."""
    return pack(product(unpack(commits), 0))


def verify_share(share, commits, point: int):
    """Per-element check ``h^share == Π_j C_j^{point^j}``.

    ``share``: words (any shape); ``commits``: words
    ``[*share.shape, degree+1, 2]``; returns a bool tensor of
    ``share.shape``.
    """
    c = unpack(commits)
    k = int(c.shape[-1])
    lhs = gpow(share)
    # Horner in the exponent: Π C_j^{x^j} = C_0 · (C_1 · (...)^x)^x
    acc = c[..., k - 1]
    for j in range(k - 2, -1, -1):
        acc = qmul(qpow_scalar(acc, point), c[..., j])
    return lhs == acc


# ---------------------------------------------------------------------------
# Host-side (Python int) oracles for tests
# ---------------------------------------------------------------------------

def to_int(packed) -> np.ndarray:
    """Words ``[..., 2]`` -> object array of Python ints."""
    a = np.asarray(packed, dtype=np.int64).astype(np.uint64)
    return (a[..., 0].astype(object) * (1 << 32)) + a[..., 1].astype(object)


def np_commit(coeffs) -> np.ndarray:
    """Python-int Feldman commit: list of int arrays -> object [..., k]."""
    cols = []
    for a in coeffs:
        flat = [pow(VSS_GEN_INT, int(x), VSS_Q_INT)
                for x in np.asarray(a).ravel()]
        cols.append(np.array(flat, dtype=object).reshape(np.shape(a)))
    return np.stack(cols, axis=-1)


def np_verify_share(share, commit_ints, point: int) -> np.ndarray:
    """Python-int oracle of ``verify_share`` (object-array commits)."""
    share = np.asarray(share)
    commit_ints = np.asarray(commit_ints, dtype=object)
    out = np.zeros(share.shape, dtype=bool)
    k = commit_ints.shape[-1]
    for idx in np.ndindex(*share.shape):
        rhs = int(commit_ints[idx + (k - 1,)])
        for j in range(k - 2, -1, -1):
            rhs = pow(rhs, point, VSS_Q_INT)
            rhs = rhs * int(commit_ints[idx + (j,)]) % VSS_Q_INT
        out[idx] = pow(VSS_GEN_INT, int(share[idx]), VSS_Q_INT) == rhs
    return out
