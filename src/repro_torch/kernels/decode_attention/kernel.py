"""Launch of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:72``
(``decode_attention_pallas``).  The source's header note says what
bounds it on the H100 and how its design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_decode_attention"
#: keys per staged tile (``kBK`` in the source)
BLOCK_K = 128
#: the card's dynamic shared memory per block (H100: 227 KB)
MAX_SMEM_BYTES = 232_448


def smem_bytes(group: int, d: int) -> int:
    """Shared memory of one launch: q and acc ``[group, d]``, the key
    tile ``[BLOCK_K, d + 1]``, the value tile ``[BLOCK_K, d]``, the scores
    ``[group, BLOCK_K]`` and m, l, alpha ``[group]`` (float32)."""
    return 4 * (2 * group * d + BLOCK_K * (d + 1) + BLOCK_K * d
                + group * BLOCK_K + 3 * group)


def decode_attention_cuda(q, k, v, *, kv_len: int, scale: float):
    """q ``[B,Hq,D]``, cache k/v ``[B,Hkv,S,D]`` (last dims contiguous)
    -> float32 (acc ``[B,Hq,D]``, m ``[B,Hq]``, l ``[B,Hq]``)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if acc.numel():
        dispatch.launch(NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq,
                        hkv, d, kv_len, *q.stride()[:2], *k.stride()[:3],
                        *v.stride()[:3], scale, dispatch.DTYPE_CODES[q.dtype],
                        dispatch.DTYPE_CODES[k.dtype])
    return acc, m, l
