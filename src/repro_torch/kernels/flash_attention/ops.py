"""Wrapper of the flash-attention kernel: the tensor's device picks.

A CPU tensor goes through the plain version (``ref.attention_ref``); a
CUDA tensor goes through the CUDA kernel or raises.  The reference's
wrapper sends shapes its TPU tiling cannot cover (``Sq % 8``,
``Skv % 128``) to its oracle; the CUDA kernel masks the ragged tails
itself, so no shape is sent anywhere else.  bfloat16 inputs run on the
tensor cores (``flash_attention_mma_kernel``), float32 inputs on the CUDA
cores (``flash_attention_kernel``): ``csrc/flash_attention.cu``'s note
says why.  The kernel has no backward (nor has the reference's, ROADMAP
queue 3, finding 1): a call on the card while autograd records raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from .kernel import flash_attention_cuda
from .ref import attention_ref

#: the kernel's widest head (``csrc/flash_attention.cu``: instantiated
#: for D up to 32, 64, 128 and 256)
MAX_HEAD_DIM = 256
#: gridDim.y and gridDim.z carry the query head and the batch row in
#: float32, the batch row and the q-tile in bfloat16
MAX_GRID_YZ = 65535
#: query rows of a bfloat16 q-tile (gridDim.z): at most MAX_GRID_YZ tiles
BF16_TILE_ROWS = 64

NO_BACKWARD = ("the flash-attention kernel has no backward: the "
               "reference's cannot be differentiated either (ROADMAP queue "
               "3, finding 1); training runs 'dense' or 'xla_chunked'")


def records_grad(*tensors) -> bool:
    """True when autograd would record an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_inputs(q, k, v) -> None:
    """Shape, type and layout checks of a CUDA flash-attention call."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]"
                         f", got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in dispatch.DTYPE_CODES:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if hq > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: at most {MAX_GRID_YZ} heads and "
                         f"batch rows per launch, got {hq}, {b}")
    if q.dtype == torch.bfloat16 \
            and -(-q.shape[2] // BF16_TILE_ROWS) > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: at most "
                         f"{MAX_GRID_YZ * BF16_TILE_ROWS} bfloat16 query "
                         f"rows per launch, got {q.shape[2]}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float | None = None):
    """q: ``[B,Hq,Sq,D]``, k/v: ``[B,Hkv,Skv,D]`` -> ``[B,Hq,Sq,D]`` of
    q's dtype."""
    if dispatch.on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale).to(q.dtype)
    if records_grad(q, k, v):
        raise NotImplementedError(NO_BACKWARD)
    check_inputs(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[3])
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)
