"""Launch of the CUDA Feldman verification kernel
(``csrc/verify_shares.cu``).

Replaces ``repro/kernels/verify_shares/kernel.py:43``
(``verify_shares_pallas``).  The source's header note says what bounds
it on the H100 and how its design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_verify_shares"


def verify_shares_cuda(rows: torch.Tensor, commits: torch.Tensor,
                       points: tuple[int, ...]):
    """int32 rows ``[k, D]`` + int32 commits ``[D, c, 2]`` -> int32
    flags ``[k, D]``."""
    k, d = rows.shape
    pts = dispatch.device_ints(points, rows.device)
    out = torch.empty((k, d), dtype=torch.int32, device=rows.device)
    if d:
        dispatch.launch(NAME, rows.data_ptr(), commits.data_ptr(),
                        pts.data_ptr(), out.data_ptr(), k, d,
                        int(commits.shape[1]))
    return out
