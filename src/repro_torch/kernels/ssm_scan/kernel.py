"""Launch of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

Replaces ``repro/kernels/ssm_scan/kernel.py:55`` (``ssm_scan_pallas``).
The source's header note says what bounds it on the H100 and how its
design answers that.
"""

from __future__ import annotations

import ctypes

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


#: the launch plan's fields, in ``repro_ssm_scan_plan``'s order
PLAN_KEYS = ("halves", "states_a_thread", "threads", "blocks",
             "blocks_an_sm", "sms", "registers", "smem_bytes", "tile_steps",
             "stages")


def launch_plan(b: int, di: int, st: int, dtype) -> dict:
    """How the kernel would launch on this card for ``[b, ·, di]`` with
    ``st`` states: its geometry, the registers ptxas gave it, the blocks
    an SM holds at once and the waves the grid takes."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    rc = dispatch.utility("repro_ssm_scan_plan")(
        b, di, st, dispatch.DTYPE_CODES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"repro_ssm_scan_plan failed with error {rc}")
    plan = dict(zip(PLAN_KEYS, out))
    plan["waves"] = plan["blocks"] / (plan["blocks_an_sm"] * plan["sms"])
    return plan
