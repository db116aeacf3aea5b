"""Launch of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:104``
(``flash_attention_pallas``).  One C entry takes both types: bfloat16
runs on the tensor cores (mma.sync, a cp.async ring of bf16 K/V tiles,
the softmax in registers, P fed as two bf16 halves), float32 on the CUDA
cores, since TF32 would break the float32 tolerance.  The source's
header note says what bounds each on the H100 and how its design answers
that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_flash_attention"


def flash_attention_cuda(q, k, v, *, causal: bool, window: int,
                         scale: float):
    """q ``[B,Hq,Sq,D]``, k/v ``[B,Hkv,Skv,D]`` (last dim contiguous) ->
    contiguous ``[B,Hq,Sq,D]`` of q's dtype."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel():
        dispatch.launch(NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, hq, hkv, sq, skv, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        scale, int(causal), int(window),
                        dispatch.DTYPE_CODES[q.dtype])
    return out
