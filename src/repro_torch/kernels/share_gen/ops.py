"""Wrapper of the share-generation kernel: the tensor's device picks.

A CPU tensor goes through the plain version (``int64`` words); a CUDA
tensor goes through the CUDA kernel (``int32`` bit patterns) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch
from .kernel import share_gen_batch_cuda
from .ref import share_gen_batch_ref

#: gridDim.y carries the party index
MAX_PARTIES = 65535


def check_batch_inputs(flats, m: int, keys, name: str) -> None:
    """Shape, type and contiguity checks of a CUDA share-kernel call."""
    if flats.dtype != torch.float32 or flats.ndim != 2 \
            or not flats.is_contiguous():
        raise ValueError(f"{name}: flats must be contiguous float32 [l, D], "
                         f"got {flats.dtype} {tuple(flats.shape)}")
    l, d = flats.shape
    if d % 4 == 0 and flats.data_ptr() % 16 != 0:
        # rows of a multiple of four elements are read as float4
        # (csrc/quad_io.cuh); a view at another offset would fault
        raise ValueError(f"{name}: flats with D % 4 == 0 must start on a "
                         f"16-byte boundary, got a view at storage offset "
                         f"{flats.storage_offset()}")
    if keys.dtype != torch.int32 or tuple(keys.shape) != (l, 2) \
            or not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be contiguous int32 [{l}, 2], "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if not 1 <= m:
        raise ValueError(f"{name}: need at least one share, got m={m}")
    if l > MAX_PARTIES:
        raise ValueError(f"{name}: at most {MAX_PARTIES} parties per "
                         f"launch, got {l}")


def share_gen_batch(flats, m: int, keys, cfg: FixedPointConfig,
                    counter_base: int = 0):
    """All parties' additive share stacks: ``[l, D] -> [l, m, D]``.

    Slice ``p`` equals ``core.additive.share(cfg.encode(flats[p]), m,
    *keys[p], counter_base)``.
    """
    if dispatch.on_cpu(flats, keys):
        return share_gen_batch_ref(flats, m, keys, cfg,
                                   counter_base=counter_base)
    if cfg.algebra != "ring":
        raise ValueError("share_gen needs the ring codec")
    check_batch_inputs(flats, m, keys, "share_gen_batch")
    return share_gen_batch_cuda(flats, m, keys, cfg, counter_base)
