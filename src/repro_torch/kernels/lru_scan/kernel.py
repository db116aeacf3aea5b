"""Launch of the CUDA RG-LRU scan kernel (``csrc/lru_scan.cu``).

Replaces ``repro/kernels/lru_scan/kernel.py:42`` (``lru_scan_pallas``).
The source's header note says what bounds it on the H100 and how its
design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_lru_scan"
#: gridDim.y carries the batch row
MAX_BATCH = 65535


def lru_scan_cuda(a, b):
    """a, b contiguous ``[B, S, W]`` of one dtype -> contiguous h
    ``[B, S, W]`` of a's dtype."""
    bsz, s, w = a.shape
    h = torch.empty((bsz, s, w), dtype=a.dtype, device=a.device)
    if h.numel():
        dispatch.launch(NAME, a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz,
                        s, w, dispatch.DTYPE_CODES[a.dtype])
    return h
