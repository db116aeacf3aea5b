"""Shamir secret sharing over the Mersenne-31 field (paper §III-A).

Counterpart of ``repro/core/shamir.py``: the secret is the constant term
of a degree-``d`` polynomial with Philox coefficients; share ``w`` is its
value at ``x = w`` (1-based), by Horner's rule; any ``d+1`` shares give
back the secret by Lagrange interpolation at 0.  As in ``core.additive``
the codeword is the last axis and leading axes are a batch of parties.
``share_with_commitments`` adds the Feldman commitments of ``core.vss``
and ``reconstruct_verified`` drops the rows that fail them.
"""

from __future__ import annotations

import functools

import torch

from . import philox
from .field import MERSENNE_P, fadd, fmul, to_field, u32


def share(v, m: int, key0, key1, degree: int | None = None,
          counter_base: int = 0):
    """Split field codewords ``v [*B, D]`` into ``m`` shares ``[m, *B, D]``.

    ``degree`` defaults to ``m - 1`` (the paper's choice);
    ``counter_base`` as in ``core.additive.share``.
    """
    d = (m - 1) if degree is None else degree
    if not 0 <= d < m:
        raise ValueError(f"degree {d} must satisfy 0 <= d < m={m}")
    v = u32(v)
    n = v.shape[-1]
    coeffs = [to_field(philox.random_bits(n, key0, key1, counter_hi=j + 1,
                                          counter_base=counter_base,
                                          device=v.device)
                       .expand(v.shape))
              for j in range(d)]  # a_1 .. a_d
    shares = []
    for x in range(1, m + 1):
        # Horner: q(x) = ((a_d x + a_{d-1}) x + ...) x + v
        acc = torch.zeros_like(v)
        for a in reversed(coeffs):
            acc = fadd(fmul(acc, x), a)
        shares.append(fadd(fmul(acc, x), v))
    return torch.stack(shares, dim=0)


@functools.lru_cache(maxsize=64)
def lagrange_weights_at_zero(points: tuple[int, ...]) -> tuple[int, ...]:
    """Weights ``w_k = prod_{j != k} x_j / (x_j - x_k)`` mod p, as host
    Python ints (exact)."""
    p = MERSENNE_P
    ws = []
    for k, xk in enumerate(points):
        num, den = 1, 1
        for j, xj in enumerate(points):
            if j == k:
                continue
            num = (num * xj) % p
            den = (den * ((xj - xk) % p)) % p
        ws.append((num * pow(den, p - 2, p)) % p)
    return tuple(ws)


def reconstruct(shares, points: tuple[int, ...] | None = None):
    """Interpolate ``q(0)`` from shares ``[k, ...]`` at ``points``
    (default ``1..k``)."""
    shares = u32(shares)
    k = shares.shape[0]
    if points is None:
        points = tuple(range(1, k + 1))
    if len(points) != k:
        raise ValueError("points/shares length mismatch")
    ws = lagrange_weights_at_zero(tuple(int(x) for x in points))
    acc = fmul(shares[0], ws[0])
    for i in range(1, k):
        acc = fadd(acc, fmul(shares[i], ws[i]))
    return acc


def share_with_commitments(v, m: int, key0, key1,
                           degree: int | None = None,
                           counter_base: int = 0):
    """``share()`` plus Feldman commitments to the same polynomial.

    The commitments re-derive the coefficients from the same
    ``(key, counter_base)`` as the shares, so a chunk at offset ``off``
    with ``counter_base=off//4`` gives the sliced whole-vector result.

    Returns ``(shares [m, *v.shape], commits [*v.shape, d+1, 2])``, both
    ``int64`` words.
    """
    from . import vss
    d = (m - 1) if degree is None else degree
    shares = share(v, m, key0, key1, degree=degree,
                   counter_base=counter_base)
    commits = vss.feldman_commit(v, key0, key1, degree=d,
                                 counter_base=counter_base)
    return shares, commits


def reconstruct_verified(member_rows, agg_commits,
                         points: tuple[int, ...], degree: int):
    """Verify member rows ``[k, D]`` against aggregate commitments
    ``[D, degree+1, 2]``, reconstruct from the verified rows, and name
    the failing ones.

    Returns ``(value [D], bad_rows)``; raises ``ValueError`` when fewer
    than ``degree + 1`` rows verify.
    """
    from . import vss
    member_rows = u32(member_rows)
    k = int(member_rows.shape[0])
    if len(points) != k:
        raise ValueError("points/rows length mismatch")
    ok = [bool(vss.verify_share(member_rows[i], agg_commits,
                                points[i]).all())
          for i in range(k)]
    good = [i for i in range(k) if ok[i]]
    bad = tuple(i for i in range(k) if not ok[i])
    if len(good) < degree + 1:
        raise ValueError(
            f"only {len(good)} of {k} member rows verified but "
            f"reconstruction needs degree+1={degree + 1}")
    value = reconstruct(member_rows[good],
                        points=tuple(points[i] for i in good))
    return value, bad
