"""Plain PyTorch versions of the fused additive share-generation kernels.

Batch contract (bit-exact for ``kernels/csrc/share_gen.cu``): for float32
updates ``x [l, D]`` and per-party keys ``[l, 2]``,

  1. ring encode ``u = encode(x)`` (``core.fixed_point``),
  2. masks ``M_j`` = Philox words with counter
     ``(counter_base + i//4, 0, j, 0)``, word ``i % 4``, j = 1..m-1,
  3. shares ``S_j = M_j`` (j < m), ``S_m = u - sum_j M_j`` (mod 2^32).

Returns ``int64`` words ``[l, m, D]``.

Single-party contract (the reference's ``share_gen`` with its default
``layout="tiled"``): one float32 row ``x [D]`` and one key, masks with
counter ``(i//4, hi_base + j, 0, 0)``; returns ``int64`` words
``[m, D]``.  The reference's ``[R, 128]`` view of the same words, padded
with encoded zeros, is this row tile by tile.

Both run on any device; the wrappers send them CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.core import additive, philox
from repro_torch.core.field import U32_MASK, u32
from repro_torch.core.fixed_point import FixedPointConfig


def share_gen_batch_ref(flats, m: int, keys, cfg: FixedPointConfig,
                        counter_base: int = 0):
    if cfg.algebra != "ring":
        raise ValueError("share_gen needs the ring codec")
    keys = u32(keys)
    shares = additive.share(cfg.encode(flats), m, keys[:, 0], keys[:, 1],
                            counter_base=counter_base)
    return shares.transpose(0, 1).contiguous()


def share_gen_ref(flat, m: int, key0, key1, cfg: FixedPointConfig,
                  hi_base: int = 0):
    """float32 ``[D]`` -> ``int64`` words ``[m, D]``."""
    if cfg.algebra != "ring":
        raise ValueError("share_gen needs the ring codec")
    if m < 1:
        raise ValueError(f"need at least one share, got m={m}")
    u = cfg.encode(flat)
    d = u.shape[-1]
    masks = [philox.random_bits(d, int(key0), int(key1),
                                counter_hi=hi_base + j + 1,
                                device=u.device, layout="tiled")
             for j in range(m - 1)]
    last = u
    for mask in masks:
        last = (last - mask) & U32_MASK
    return torch.stack(masks + [last], dim=0)
