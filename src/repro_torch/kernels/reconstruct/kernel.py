"""Launch of the CUDA ring reconstruct kernel (``csrc/reconstruct.cu``).

Replaces ``repro/kernels/reconstruct/kernel.py:33``
(``reconstruct_pallas``).  The source's header note says what bounds it
on the H100 and how its design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

NAME = "repro_reconstruct"


def reconstruct_cuda(shares: torch.Tensor, n: int, cfg: FixedPointConfig,
                     inv_scale: float | None = None):
    """int32 ``[m, D]`` -> float32 ``[D]``."""
    m, d = shares.shape
    out = torch.empty((d,), dtype=torch.float32, device=shares.device)
    if d:
        dispatch.launch(NAME, shares.data_ptr(), out.data_ptr(), m, d,
                        1.0 / cfg.scale if inv_scale is None else inv_scale,
                        float(n))
    return out
