"""Launch of the CUDA decode-attention kernels (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:72``
(``decode_attention_pallas``).  The source's header note says what
bounds it on the H100 and how its design answers that: the keys below
``kv_len`` are cut into splits (``split_plan``), one block of the split
kernel per (split, KV head, batch row), and a fold kernel merges the
splits' partials in split order, on the same stream, from the same C
entry.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import dispatch

NAME = "repro_decode_attention"
#: SMs of an H100 SXM.  A launch aims at one wave of blocks where each KV
#: head has one query row (bytes-bound: 8-warp blocks with loads in
#: flight saturate the memory, and a fold would only add a launch), two
#: waves where a group shares each key (the arithmetic wants the warps)
SMS = 132
#: a split's length is a multiple of this many keys (the fewest a split
#: takes, so a short cache takes one split)
SPLIT_KEYS = 16
#: the most query rows × head dim (its bucket) a block of the split kernel
#: holds: 128 threads in teams of D/8 lanes, 4 rows a team
MAX_GROUP_DIM = 4096


def head_dim_bucket(d: int) -> int:
    """The head dim the kernel pads ``d`` to: 32, 64, 128 or 256."""
    for bucket in (32, 64, 128, 256):
        if d <= bucket:
            return bucket
    raise ValueError(f"decode_attention: head dim {d} above 256")


def fits_block(group: int, d: int) -> bool:
    """Whether a block holds a group of ``group`` query rows at head dim
    ``d``: ``group · bucket(d) ≤ MAX_GROUP_DIM``."""
    return group * head_dim_bucket(d) <= MAX_GROUP_DIM


@functools.lru_cache(maxsize=4096)
def split_plan(b: int, hkv: int, kv_len: int,
               group: int) -> tuple[int, int]:
    """(splits, keys a split) for a cache of ``kv_len`` keys under ``b``
    batch rows × ``hkv`` KV heads of ``group`` query rows each: as many
    splits as fit ``SMS`` blocks (group 1) or ``2 · SMS`` (a group),
    none shorter than ``SPLIT_KEYS`` keys unless the whole cache is;
    split ``i`` takes keys ``[i·chunk, min(kv_len, (i+1)·chunk))``, the
    last one ragged."""
    if kv_len < 1:
        raise ValueError(f"decode_attention: kv_len {kv_len} below 1")
    target = SMS if group == 1 else 2 * SMS
    splits = max(1, min(target // (b * hkv), -(-kv_len // SPLIT_KEYS)))
    chunk = -(-kv_len // splits)
    chunk = -(-chunk // SPLIT_KEYS) * SPLIT_KEYS
    return -(-kv_len // chunk), chunk


def decode_attention_cuda(q, k, v, *, kv_len: int, scale: float,
                          normalize: bool = False):
    """q ``[B,Hq,D]``, cache k/v ``[B,Hkv,S,D]`` (last dims contiguous)
    -> float32 (acc ``[B,Hq,D]``, m ``[B,Hq]``, l ``[B,Hq]``), or with
    ``normalize`` acc / l as ``[B,Hq,D]`` of q's dtype."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    splits, chunk = split_plan(b, hkv, kv_len, hq // hkv)
    dev = q.device
    rows = b * hq
    if normalize:
        out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
        ptrs = (0, 0, 0, out.data_ptr())
    else:
        acc = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
        ml = torch.empty((2, b, hq), dtype=torch.float32, device=dev)
        ptrs = (acc.data_ptr(), ml.data_ptr(), ml[1].data_ptr(), 0)
    # the splits' partials, which the fold kernel reads: acc
    # [splits, B, Hq, D], then m and l [splits, B, Hq], in one buffer
    part_ptrs = (0, 0, 0)
    if splits > 1:
        parts = torch.empty(splits * rows * (d + 2), dtype=torch.float32,
                            device=dev)
        base = parts.data_ptr()
        part_ptrs = (base, base + 4 * splits * rows * d,
                     base + 4 * splits * rows * (d + 1))
    if rows * d:
        dispatch.launch(NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        *ptrs, *part_ptrs, b, hq, hkv, d, kv_len, splits,
                        chunk, *q.stride()[:2], *k.stride()[:3],
                        *v.stride()[:3], scale,
                        dispatch.DTYPE_CODES[q.dtype],
                        dispatch.DTYPE_CODES[k.dtype])
    return out if normalize else (acc, ml[0], ml[1])
