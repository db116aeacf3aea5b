"""Plain PyTorch versions of the Shamir kernels.

Share contract (bit-exact for ``kernels/csrc/shamir.cu``): for float32
``x [l, D]`` and keys ``[l, 2]``, field-encode (negatives as
``p - |q|``), draw coefficients ``a_j = to_field(Philox words)`` with
counter ``(counter_base + i//4, 0, j, 0)`` for j = 1..d, and evaluate by
Horner at x = 1..m.  Returns ``int64`` words ``[l, m, D]`` in ``[0, p)``.

Reconstruct contract: ``out = decode(sum_k w_k * s_k mod p) / n`` with
the host Lagrange weights at 0, symmetric decode, an exact
power-of-two unscale and one IEEE division by ``n``.
"""

from __future__ import annotations

import torch

from repro_torch.core import shamir
from repro_torch.core.field import MERSENNE_P, fadd, fmul, u32
from repro_torch.core.fixed_point import FixedPointConfig, true_div


def shamir_share_batch_ref(flats, m: int, keys, cfg: FixedPointConfig,
                           degree: int | None = None, counter_base: int = 0):
    if cfg.algebra != "field":
        raise ValueError("shamir shares need the field codec")
    keys = u32(keys)
    shares = shamir.share(cfg.encode(flats), m, keys[:, 0], keys[:, 1],
                          degree=degree, counter_base=counter_base)
    return shares.transpose(0, 1).contiguous()


def shamir_reconstruct_ref(member_sums, n: int, cfg: FixedPointConfig,
                           points: tuple[int, ...] | None = None):
    """``[k, D]`` field sums -> float32 ``[D]`` decoded mean."""
    sums = u32(member_sums)
    k = sums.shape[0]
    ws = shamir.lagrange_weights_at_zero(points or tuple(range(1, k + 1)))
    acc = fmul(sums[0], ws[0])
    for i in range(1, k):
        acc = fadd(acc, fmul(sums[i], ws[i]))
    is_neg = acc > MERSENNE_P // 2
    mag = torch.where(is_neg, MERSENNE_P - acc, acc).to(torch.float32)
    return true_div(torch.where(is_neg, -mag, mag) * (1.0 / cfg.scale), n)
