"""Wrapper of the share-generation kernel: the tensor's device picks.

A CPU tensor goes through the plain version (``int64`` words); a CUDA
tensor goes through the CUDA kernel (``int32`` bit patterns) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch
from .kernel import share_gen_batch_cuda, share_gen_cuda
from .ref import share_gen_batch_ref, share_gen_ref

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


def check_single_inputs(flat, m: int, name: str) -> None:
    """Shape, type and contiguity checks of a CUDA single-party call."""
    if flat.dtype != torch.float32 or flat.ndim != 1 \
            or not flat.is_contiguous():
        raise ValueError(f"{name}: flat must be contiguous float32 [D], "
                         f"got {flat.dtype} {tuple(flat.shape)}")
    if flat.shape[0] % 4 == 0 and flat.data_ptr() % 16 != 0:
        # read as float4 (csrc/quad_io.cuh), as in check_batch_inputs
        raise ValueError(f"{name}: flat with D % 4 == 0 must start on a "
                         f"16-byte boundary, got a view at storage offset "
                         f"{flat.storage_offset()}")
    if not 1 <= m:
        raise ValueError(f"{name}: need at least one share, got m={m}")


def host_key(key) -> int:
    """A key word as a host int.  Keys of the single-party path are host
    scalars (``philox.derive_key`` of ints); a key on the card would make
    the launch wait for it, so it is refused."""
    if isinstance(key, torch.Tensor):
        if key.device.type != "cpu" or key.numel() != 1:
            raise ValueError("single-party share keys must be host scalars, "
                             f"got a {key.device} tensor of shape "
                             f"{tuple(key.shape)}")
        key = key.item()
    return int(key)


def share_gen(flat, m: int, key0, key1, cfg: FixedPointConfig,
              hi_base: int = 0):
    """One party's additive shares: float32 ``[D] -> [m, D]``.

    The counterpart of the reference's ``share_gen`` (``layout="tiled"``)
    without its tile padding: row ``j`` equals the first ``D`` words of
    the reference's ``shares[j].reshape(-1)``.  ``key0``/``key1`` are
    host scalars.
    """
    k0, k1 = host_key(key0), host_key(key1)
    if dispatch.on_cpu(flat):
        return share_gen_ref(flat, m, k0, k1, cfg, hi_base=hi_base)
    if cfg.algebra != "ring":
        raise ValueError("share_gen needs the ring codec")
    check_single_inputs(flat, m, "share_gen")
    return share_gen_cuda(flat, m, k0, k1, cfg, hi_base)
