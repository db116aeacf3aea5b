"""Wrapper of the Feldman verification kernel: the tensor's device picks.

A CPU tensor goes through the plain version; a CUDA tensor goes through
the CUDA kernel or raises.  The shape checks are the reference's
(``repro/kernels/verify_shares/ops.py``); its identity padding and
plane-major tiles are not needed, since the kernel reads flat rows.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from .kernel import verify_shares_cuda
from .ref import verify_shares_ref

#: gridDim.y carries the row index
MAX_ROWS = 65535


def verify_shares(rows, commits, points: tuple[int, ...]):
    """Batch-verify ``k`` rows of shares or partial sums.

    Args:
      rows: ``[k, D]`` field words at ``points[i]`` per row (a dealer's
        shares, or a member's partial sum).
      commits: ``[D, c, 2]`` element-major (aggregate) commitments,
        ``c = degree + 1``.
      points: the ``k`` Shamir evaluation points.

    Returns:
      ``int32 [k, D]``: 1 where the Feldman equation holds.
    """
    if rows.ndim != 2:
        raise ValueError(f"rows must be [k, D], got {tuple(rows.shape)}")
    if commits.ndim != 3 or tuple(commits.shape) != (
            rows.shape[1], commits.shape[1], 2) or commits.shape[1] < 1:
        raise ValueError(
            f"commits must be [D, c, 2] with D={rows.shape[1]}, got "
            f"{tuple(commits.shape)}")
    points = tuple(int(x) for x in points)
    if rows.shape[0] != len(points):
        raise ValueError(f"{rows.shape[0]} rows but {len(points)} points")
    if dispatch.on_cpu(rows, commits):
        return verify_shares_ref(rows, commits, points)
    if rows.dtype != torch.int32 or commits.dtype != torch.int32 \
            or not rows.is_contiguous() or not commits.is_contiguous():
        raise ValueError(
            "verify_shares: rows and commits must be contiguous int32, "
            f"got {rows.dtype} and {commits.dtype}")
    if not 1 <= len(points) <= MAX_ROWS:
        raise ValueError(f"verify_shares: 1..{MAX_ROWS} rows per launch, "
                         f"got {len(points)}")
    if any(not 0 <= x < 2 ** 31 for x in points):
        raise ValueError(f"verify_shares: points must lie in [0, 2^31), "
                         f"got {points}")
    return verify_shares_cuda(rows, commits, points)
