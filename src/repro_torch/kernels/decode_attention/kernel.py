"""Launch of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:72``
(``decode_attention_pallas``).  The source's header note says what
bounds it on the H100 and how its design answers that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NAME = "repro_decode_attention"
#: keys per staged tile (``kBK`` in the source), the first that fits
BLOCK_K_CHOICES = (128, 64)
#: the card's dynamic shared memory per block (H100: 227 KB)
MAX_SMEM_BYTES = 232_448


def smem_bytes(group: int, d: int, block_k: int) -> int:
    """Shared memory of one launch: q and acc ``[group, d]``, the key
    tile ``[block_k, d + 1]``, the value tile ``[block_k, d]``, the scores
    ``[group, block_k]`` and m, l, alpha ``[group]`` (float32)."""
    return 4 * (2 * group * d + block_k * (d + 1) + block_k * d
                + group * block_k + 3 * group)


def block_keys(group: int, d: int) -> int:
    """The key tile of a launch: 128 keys where they fit the card's shared
    memory (every dense config: qwen1.5-0.5b's group 1 × D 64 takes
    67,084 B), else 64 (recurrentgemma-9b's group 16 × D 256: 168,384 B
    against 303,808 B at 128)."""
    for block_k in BLOCK_K_CHOICES:
        if smem_bytes(group, d, block_k) <= MAX_SMEM_BYTES:
            return block_k
    return BLOCK_K_CHOICES[-1]


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
                        hkv, d, kv_len, block_keys(hq // hkv, d),
                        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
                        scale, dispatch.DTYPE_CODES[q.dtype],
                        dispatch.DTYPE_CODES[k.dtype])
    return acc, m, l
