"""Additive secret sharing over the ring Z_2^32 (paper Alg. 1, bulk form).

Counterpart of ``repro/core/additive.py``: ``m-1`` Philox masks and a
last share ``v - sum(masks)``; reconstruction is the wrap-around sum.
The codeword is the last axis of ``v``; leading axes are a batch of
parties, each with its own key, so one call shares a whole party chunk.
This is the plain version the ``share_gen`` kernel is held against.
"""

from __future__ import annotations

import torch

from . import philox
from .field import U32_MASK, ring_sum, u32


def share(v, m: int, key0, key1, counter_base: int = 0):
    """Split codewords ``v [*B, D]`` into ``m`` shares ``[m, *B, D]``.

    ``key0``/``key1``: ints, or ``int64`` words of shape ``B``.
    ``counter_base``: counter offset in 4-word blocks; sharing elements
    ``[off, off+L)`` with ``counter_base=off//4`` (``off % 4 == 0``)
    gives exactly that slice of the whole-vector shares.
    """
    if m < 1:
        raise ValueError(f"need at least one share, got m={m}")
    v = u32(v)
    if m == 1:
        return v[None]
    d = v.shape[-1]
    masks = [philox.random_bits(d, key0, key1, counter_hi=j + 1,
                                counter_base=counter_base, device=v.device)
             .expand(v.shape)
             for j in range(m - 1)]
    last = v
    for mask in masks:
        last = (last - mask) & U32_MASK
    return torch.stack(masks + [last], dim=0)


def reconstruct(shares):
    """Wrap-around sum over the leading share axis."""
    return ring_sum(shares, axis=0)
