"""Wrapper of the RG-LRU scan kernel: the tensor's device picks.

A CPU tensor goes through the plain version (``ref.lru_scan_ref``); a
CUDA tensor goes through the CUDA kernel or raises.  The reference's
wrapper sends ``S % 128`` and ``W % 128`` to its oracle; the CUDA kernel
masks the ragged channel tail and takes any length, so no shape is sent
anywhere else.  The kernel has no backward (nor can the reference's be
differentiated, ROADMAP queue 3, finding 5): a call on the card while
autograd records raises.
"""

from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import records_grad
from .kernel import MAX_BATCH, lru_scan_cuda
from .ref import lru_scan_ref

NO_BACKWARD = ("the RG-LRU scan kernel has no backward: the reference's "
               "cannot be differentiated either (ROADMAP queue 3, finding "
               "5); training runs the chunked scan (impl='dense')")


def check_inputs(a, b) -> None:
    """Shape, type and layout checks of a CUDA RG-LRU scan call."""
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan: a, b [B,S,W], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in dispatch.DTYPE_CODES:
        raise ValueError(f"lru_scan: a and b must share float32 or "
                         f"bfloat16, got {a.dtype}, {b.dtype}")
    if a.shape[0] > MAX_BATCH:
        raise ValueError(f"lru_scan: at most {MAX_BATCH} batch rows per "
                         f"launch, got {a.shape[0]}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("lru_scan: a and b must be contiguous")


def lru_scan(a, b):
    """a, b: ``[B,S,W]`` -> every state h ``[B,S,W]`` of a's dtype (as the
    Pallas kernel's ``out_shape``), carried in float32 from h = 0."""
    if dispatch.on_cpu(a, b):
        return lru_scan_ref(a, b).to(a.dtype)
    if records_grad(a, b):
        raise NotImplementedError(NO_BACKWARD)
    check_inputs(a, b)
    return lru_scan_cuda(a, b)
