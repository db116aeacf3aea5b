"""Plain PyTorch versions of the Shamir kernels.

Share contract (bit-exact for ``kernels/csrc/shamir.cu``): for float32
``x [l, D]`` and keys ``[l, 2]``, field-encode (negatives as
``p - |q|``), draw coefficients ``a_j = to_field(Philox words)`` with
counter ``(counter_base + i//4, 0, j, 0)`` for j = 1..d, and evaluate by
Horner at x = 1..m.  Returns ``int64`` words ``[l, m, D]`` in ``[0, p)``.

Single-party share contract (the reference's ``shamir_share`` with its
default ``layout="tiled"``): one float32 row ``x [D]`` and one key,
coefficient ``a_j`` from counter ``(i//4, hi_base + j, 0, 0)``; returns
``int64`` words ``[m, D]``.

Reconstruct contract: ``out = decode(sum_k w_k * s_k mod p) * inv_scale
/ n`` with the host Lagrange weights at 0 and symmetric decode; by
default ``inv_scale`` is the exact power-of-two ``1/scale`` and the
division one IEEE division by ``n``.
"""

from __future__ import annotations

import torch

from repro_torch.core import shamir
from repro_torch.core import philox
from repro_torch.core.field import MERSENNE_P, fadd, fmul, to_field, u32
from repro_torch.core.fixed_point import FixedPointConfig, true_div


def shamir_share_batch_ref(flats, m: int, keys, cfg: FixedPointConfig,
                           degree: int | None = None, counter_base: int = 0):
    if cfg.algebra != "field":
        raise ValueError("shamir shares need the field codec")
    keys = u32(keys)
    shares = shamir.share(cfg.encode(flats), m, keys[:, 0], keys[:, 1],
                          degree=degree, counter_base=counter_base)
    return shares.transpose(0, 1).contiguous()


def shamir_share_ref(flat, m: int, key0, key1, cfg: FixedPointConfig,
                     degree: int | None = None, hi_base: int = 0):
    """float32 ``[D]`` -> ``int64`` field words ``[m, D]``."""
    if cfg.algebra != "field":
        raise ValueError("shamir shares need the field codec")
    deg = (m - 1) if degree is None else degree
    if not 0 <= deg < m:
        raise ValueError(f"degree {deg} must satisfy 0 <= d < m={m}")
    v = cfg.encode(flat)
    d = v.shape[-1]
    coeffs = [to_field(philox.random_bits(d, int(key0), int(key1),
                                          counter_hi=hi_base + j + 1,
                                          device=v.device, layout="tiled"))
              for j in range(deg)]  # a_1 .. a_d
    shares = []
    for x in range(1, m + 1):
        acc = torch.zeros_like(v)
        for a in reversed(coeffs):
            acc = fadd(fmul(acc, x), a)
        shares.append(fadd(fmul(acc, x), v))
    return torch.stack(shares, dim=0)


def shamir_reconstruct_ref(member_sums, n: int, cfg: FixedPointConfig,
                           points: tuple[int, ...] | None = None,
                           inv_scale: float | None = None):
    """``[k, D]`` field sums -> float32 ``[D]`` decoded mean."""
    sums = u32(member_sums)
    k = sums.shape[0]
    ws = shamir.lagrange_weights_at_zero(points or tuple(range(1, k + 1)))
    acc = fmul(sums[0], ws[0])
    for i in range(1, k):
        acc = fadd(acc, fmul(sums[i], ws[i]))
    is_neg = acc > MERSENNE_P // 2
    mag = torch.where(is_neg, MERSENNE_P - acc, acc).to(torch.float32)
    inv = 1.0 / cfg.scale if inv_scale is None else inv_scale
    return true_div(torch.where(is_neg, -mag, mag) * inv, n)
