"""Wrapper of the ring reconstruct kernel: the tensor's device picks."""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from .kernel import reconstruct_cuda
from .ref import reconstruct_ref


def reconstruct(shares, n: int, cfg, inv_scale: float | None = None):
    """``[m, D]`` ring sums -> float32 ``[D]`` decoded mean over ``n``.

    ``inv_scale`` replaces the unscale factor ``1/scale``: the SPMD path
    passes ``f32(1/(scale*n))`` with ``n = 1``, the reference's jitted
    decode (``fl.spmd``).
    """
    if dispatch.on_cpu(shares):
        return reconstruct_ref(shares, n, cfg, inv_scale=inv_scale)
    if cfg.algebra != "ring":
        raise ValueError("reconstruct needs the ring codec")
    if shares.dtype != torch.int32 or shares.ndim != 2 \
            or not shares.is_contiguous() or shares.shape[0] < 1:
        raise ValueError("reconstruct: shares must be contiguous int32 "
                         f"[m, D], got {shares.dtype} {tuple(shares.shape)}")
    return reconstruct_cuda(shares, n, cfg, inv_scale)
