"""Launches of the CUDA share-generation kernels (``csrc/share_gen.cu``).

Replace ``repro/kernels/share_gen/kernel.py:140``
(``share_gen_batch_pallas``) and ``:89`` (``share_gen_pallas``).  The
source's header note says what bounds them on the H100 and how their
design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.core.field import U32_MASK
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

NAME = "repro_share_gen_batch"
SINGLE_NAME = "repro_share_gen"


def share_gen_batch_cuda(flats: torch.Tensor, m: int, keys: torch.Tensor,
                         cfg: FixedPointConfig, counter_base: int = 0):
    """float32 ``[l, D]`` + int32 keys ``[l, 2]`` -> int32 ``[l, m, D]``."""
    l, d = flats.shape
    out = torch.empty((l, m, d), dtype=torch.int32, device=flats.device)
    if out.numel():
        dispatch.launch(NAME, flats.data_ptr(), keys.data_ptr(),
                        out.data_ptr(), l, d, m, counter_base & U32_MASK,
                        cfg.scale, cfg.clip)
    return out


def share_gen_cuda(flat: torch.Tensor, m: int, key0: int, key1: int,
                   cfg: FixedPointConfig, hi_base: int = 0):
    """float32 ``[D]`` + host key words -> int32 ``[m, D]``."""
    d = flat.shape[0]
    out = torch.empty((m, d), dtype=torch.int32, device=flat.device)
    if out.numel():
        dispatch.launch(SINGLE_NAME, flat.data_ptr(), out.data_ptr(), d, m,
                        key0 & U32_MASK, key1 & U32_MASK,
                        hi_base & U32_MASK, cfg.scale, cfg.clip)
    return out
