"""Plain PyTorch version of the fused ring reconstruct kernel.

Contract (bit-exact for ``kernels/csrc/reconstruct.cu``): for the
committee members' ring sums ``S [m, D]``,
``mean = float32(int32(sum_j S_j mod 2^32)) * inv_scale / n``; by
default ``inv_scale = 2^-f``, an exact power-of-two unscale, then one
IEEE division by ``n``.
"""

from __future__ import annotations

import torch

from repro_torch.core.field import ring_sum
from repro_torch.core.fixed_point import FixedPointConfig, true_div


def reconstruct_ref(shares, n: int, cfg: FixedPointConfig,
                    inv_scale: float | None = None):
    """``[m, D]`` ring sums -> float32 ``[D]`` decoded mean."""
    if cfg.algebra != "ring":
        raise ValueError("reconstruct needs the ring codec")
    total = ring_sum(shares, axis=0)
    signed = torch.where(total >= 2 ** 31, total - 2 ** 32, total)
    inv = 1.0 / cfg.scale if inv_scale is None else inv_scale
    return true_div(signed.to(torch.float32) * inv, n)
