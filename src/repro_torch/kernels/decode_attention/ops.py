"""Wrapper of the decode-attention kernels: partials or normalized.

A CPU tensor goes through the plain version (``ref.py``); a CUDA tensor
goes through the CUDA kernels or raises.  The reference's wrapper sends
``S % 128`` and ``group % 8`` (qwen1.5-0.5b's group is 1) to its oracle;
the CUDA kernels take every cache length, and every group whose rows fit
a block (group · bucket(D) ≤ 4,096, D ≤ 256), so no shape is sent
anywhere else.  On the card ``kv_len`` is a host int in ``[1, S]``, and
q may be float32 or bfloat16 independently of the cache's type.  The
split kernel and its fold (``kernel.py``) give the partials to
``decode_attention_partial``, and to ``decode_attention`` the normalized
result in q's dtype, written by the fold itself: no plain
``combine_partials`` or cast runs after it on the card.
"""

from __future__ import annotations

import math

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import records_grad
from .kernel import (MAX_GROUP_DIM, decode_attention_cuda, fits_block,
                     head_dim_bucket)
from .ref import combine_partials, decode_attention_ref

#: gridDim.y and gridDim.z carry the KV head and the batch row
MAX_GRID_YZ = 65535

NO_BACKWARD = ("the decode-attention kernel has no backward (nor has the "
               "reference's); decode runs without autograd")


def check_inputs(q, k, v, kv_len) -> None:
    """Shape, type, layout and length checks of a CUDA decode call."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q [B,Hq,D], k/v [B,Hkv,S,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in dispatch.DTYPE_CODES or k.dtype != v.dtype \
            or k.dtype not in dispatch.DTYPE_CODES:
        raise ValueError(f"decode_attention: q and the cache must be "
                         f"float32 or bfloat16 (k and v alike), got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: the head dim of q, k and v must "
                         "be contiguous")
    if b > MAX_GRID_YZ or k.shape[1] > MAX_GRID_YZ:
        raise ValueError(f"decode_attention: at most {MAX_GRID_YZ} KV heads "
                         f"and batch rows per launch")
    if not 1 <= d <= 256:
        raise ValueError(f"decode_attention: head dim {d} outside [1, 256]")
    group = hq // k.shape[1]
    if not fits_block(group, d):
        raise ValueError(f"decode_attention: group {group} × head dim {d} "
                         f"(bucket {head_dim_bucket(d)}) is above the "
                         f"{MAX_GROUP_DIM} rows × columns a block holds")
    if not isinstance(kv_len, int) or not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"decode_attention: kv_len must be a host int in "
                         f"[1, {k.shape[2]}] on the card, got {kv_len!r}")


def _prepare(q, k, v, kv_len, sm_scale):
    """The checks of a CUDA call; returns (kv_len, scale)."""
    if records_grad(q, k, v):
        raise NotImplementedError(NO_BACKWARD)
    kv_len = k.shape[2] if kv_len is None else kv_len
    check_inputs(q, k, v, kv_len)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[2])
    return kv_len, scale


def decode_attention_partial(q, k, v, *, kv_len=None, sm_scale=None):
    """Returns float32 (acc ``[B,Hq,D]``, m ``[B,Hq]``, l ``[B,Hq]``)
    for an LSE combination across shards."""
    if dispatch.on_cpu(q, k, v):
        return decode_attention_ref(q, k, v, kv_len=kv_len,
                                    sm_scale=sm_scale)
    kv_len, scale = _prepare(q, k, v, kv_len, sm_scale)
    return decode_attention_cuda(q, k, v, kv_len=kv_len, scale=scale)


def decode_attention(q, k, v, *, kv_len=None, sm_scale=None):
    """Normalized decode attention for an unsharded cache: ``[B,Hq,D]``
    of q's dtype."""
    if dispatch.on_cpu(q, k, v):
        acc, m, l = decode_attention_ref(q, k, v, kv_len=kv_len,
                                         sm_scale=sm_scale)
        return combine_partials(acc[None], m[None], l[None]).to(q.dtype)
    kv_len, scale = _prepare(q, k, v, kv_len, sm_scale)
    return decode_attention_cuda(q, k, v, kv_len=kv_len, scale=scale,
                                 normalize=True)
