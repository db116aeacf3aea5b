"""Wrapper of the selective-scan kernel: the tensor's device picks.

A CPU tensor goes through the plain version (``ref.ssm_scan_ref``); a
CUDA tensor goes through the CUDA kernel or raises.  The reference's
wrapper sends ``S % 128`` and ``di % 128`` to its oracle; the CUDA
kernel masks the ragged channel tail and takes any length, so no shape
is sent anywhere else.  The kernel has no backward (nor can the
reference's be differentiated, ROADMAP queue 3, finding 5): a call on
the card while autograd records raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import records_grad
from .kernel import MAX_BATCH, MAX_STATE, ssm_scan_cuda
from .ref import ssm_scan_ref

NO_BACKWARD = ("the selective-scan kernel has no backward: the reference's "
               "cannot be differentiated either (ROADMAP queue 3, finding "
               "5); training runs the chunked scan (impl='dense')")


def check_inputs(x, dt, bc, cc, a) -> None:
    """Shape, type and layout checks of a CUDA selective-scan call."""
    if x.ndim != 3 or dt.shape != x.shape or bc.ndim != 3 \
            or cc.shape != bc.shape or bc.shape[:2] != x.shape[:2] \
            or a.shape != (x.shape[2], bc.shape[2]):
        raise ValueError(f"ssm_scan: x, dt [B,S,di], bc, cc [B,S,st], a "
                         f"[di,st], got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(bc.shape)}, {tuple(cc.shape)}, "
                         f"{tuple(a.shape)}")
    if not (x.dtype == bc.dtype == cc.dtype) \
            or x.dtype not in dispatch.DTYPE_CODES:
        raise ValueError(f"ssm_scan: x, bc, cc must share float32 or "
                         f"bfloat16, got {x.dtype}, {bc.dtype}, {cc.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssm_scan: dt and a must be float32, got "
                         f"{dt.dtype}, {a.dtype}")
    if not 1 <= bc.shape[2] <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {bc.shape[2]} outside "
                         f"[1, {MAX_STATE}]")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"ssm_scan: at most {MAX_BATCH} batch rows per "
                         f"launch, got {x.shape[0]}")
    if not (x.is_contiguous() and dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssm_scan: x, dt and a must be contiguous")
    if bc.stride(2) != 1 or cc.stride(2) != 1:
        raise ValueError("ssm_scan: the state dim of bc and cc must be "
                         "contiguous")


def ssm_scan(x, dt, bc, cc, a):
    """x: ``[B,S,di]``, dt: ``[B,S,di]`` float32, bc/cc: ``[B,S,st]``,
    a: ``[di,st]`` float32 -> y ``[B,S,di]`` of x's dtype (as the Pallas
    kernel's ``out_shape``)."""
    if dispatch.on_cpu(x, dt, bc, cc, a):
        return ssm_scan_ref(x, dt, bc, cc, a).to(x.dtype)
    if records_grad(x, dt, bc, cc, a):
        raise NotImplementedError(NO_BACKWARD)
    check_inputs(x, dt, bc, cc, a)
    return ssm_scan_cuda(x, dt, bc, cc, a)
