"""Launch of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

Replaces ``repro/kernels/ssm_scan/kernel.py:55`` (``ssm_scan_pallas``).
The source's header note says what bounds it on the H100 and how its
design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_ssm_scan"
#: the widest state the kernel is instantiated for (``kMaxState``)
MAX_STATE = 16
#: gridDim.y carries the batch row
MAX_BATCH = 65535


def ssm_scan_cuda(x, dt, bc, cc, a):
    """x, dt ``[B, S, di]`` contiguous; bc, cc ``[B, S, st]`` with a
    contiguous last dim; a ``[di, st]`` contiguous float32 -> contiguous
    y ``[B, S, di]`` of x's dtype."""
    b, s, di = x.shape
    st = bc.shape[2]
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    if y.numel():
        dispatch.launch(NAME, x.data_ptr(), dt.data_ptr(), bc.data_ptr(),
                        cc.data_ptr(), a.data_ptr(), y.data_ptr(), b, s, di,
                        st, *bc.stride()[:2], *cc.stride()[:2],
                        dispatch.DTYPE_CODES[x.dtype])
    return y
