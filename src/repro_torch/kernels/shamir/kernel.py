"""Launches of the CUDA Shamir kernels (``csrc/shamir.cu``).

Replace ``repro/kernels/shamir/kernel.py:111``
(``shamir_share_batch_pallas``), ``:68`` (``shamir_share_pallas``) and
``:158`` (``shamir_reconstruct_pallas``).  The source's header note says what
bounds them on the H100 and how their design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.core.field import U32_MASK
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

SHARE_NAME = "repro_shamir_share_batch"
SINGLE_NAME = "repro_shamir_share"
RECONSTRUCT_NAME = "repro_shamir_reconstruct"
#: coefficient words kept in registers per thread (``kMaxDegree``)
MAX_DEGREE = 16


def shamir_share_batch_cuda(flats: torch.Tensor, m: int, keys: torch.Tensor,
                            cfg: FixedPointConfig, degree: int,
                            counter_base: int = 0):
    """float32 ``[l, D]`` + int32 keys ``[l, 2]`` -> int32 ``[l, m, D]``."""
    l, d = flats.shape
    out = torch.empty((l, m, d), dtype=torch.int32, device=flats.device)
    if out.numel():
        dispatch.launch(SHARE_NAME, flats.data_ptr(), keys.data_ptr(),
                        out.data_ptr(), l, d, m, degree,
                        counter_base & U32_MASK, cfg.scale, cfg.clip)
    return out


def shamir_share_cuda(flat: torch.Tensor, m: int, key0: int, key1: int,
                      cfg: FixedPointConfig, degree: int, hi_base: int = 0):
    """float32 ``[D]`` + host key words -> int32 ``[m, D]``."""
    d = flat.shape[0]
    out = torch.empty((m, d), dtype=torch.int32, device=flat.device)
    if out.numel():
        dispatch.launch(SINGLE_NAME, flat.data_ptr(), out.data_ptr(), d, m,
                        degree, key0 & U32_MASK, key1 & U32_MASK,
                        hi_base & U32_MASK, cfg.scale, cfg.clip)
    return out


def shamir_reconstruct_cuda(member_sums: torch.Tensor, weights, n: int,
                            cfg: FixedPointConfig,
                            inv_scale: float | None = None):
    """int32 ``[k, D]`` + host weights -> float32 ``[D]``."""
    k, d = member_sums.shape
    w = dispatch.device_ints(tuple(int(x) for x in weights),
                             member_sums.device)
    out = torch.empty((d,), dtype=torch.float32, device=member_sums.device)
    if d:
        dispatch.launch(RECONSTRUCT_NAME, member_sums.data_ptr(),
                        w.data_ptr(), out.data_ptr(), k, d,
                        1.0 / cfg.scale if inv_scale is None else inv_scale,
                        float(n))
    return out
