"""Wrappers of the Shamir kernels: the tensor's device picks.

A CPU tensor goes through the plain version; a CUDA tensor goes through
the CUDA kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.shamir import lagrange_weights_at_zero
from repro_torch.kernels import dispatch
from repro_torch.kernels.share_gen.ops import (check_batch_inputs,
                                               check_single_inputs, host_key)
from .kernel import (MAX_DEGREE, shamir_reconstruct_cuda,
                     shamir_share_batch_cuda, shamir_share_cuda)
from .ref import (shamir_reconstruct_ref, shamir_share_batch_ref,
                  shamir_share_ref)


def _check_degree(m: int, degree: int | None, cfg) -> int:
    d = (m - 1) if degree is None else degree
    if cfg.algebra != "field":
        raise ValueError("shamir shares need the field codec")
    if not 0 <= d < m:
        raise ValueError(f"degree {d} must satisfy 0 <= d < m={m}")
    if d > MAX_DEGREE:
        raise ValueError(f"the CUDA Shamir kernel keeps at most "
                         f"{MAX_DEGREE} coefficients, got degree {d}")
    return d


def shamir_share(flat, m: int, key0, key1, cfg, degree: int | None = None,
                 hi_base: int = 0):
    """One party's Shamir shares: float32 ``[D] -> [m, D]``.

    The counterpart of the reference's ``shamir_share``
    (``layout="tiled"``) without its tile padding.  ``key0``/``key1``
    are host scalars.
    """
    k0, k1 = host_key(key0), host_key(key1)
    if dispatch.on_cpu(flat):
        return shamir_share_ref(flat, m, k0, k1, cfg, degree=degree,
                                hi_base=hi_base)
    d = _check_degree(m, degree, cfg)
    check_single_inputs(flat, m, "shamir_share")
    return shamir_share_cuda(flat, m, k0, k1, cfg, d, hi_base)


def shamir_share_batch(flats, m: int, keys, cfg, degree: int | None = None,
                       counter_base: int = 0):
    """All parties' Shamir share stacks: ``[l, D] -> [l, m, D]``.

    Slice ``p`` equals ``core.shamir.share(cfg.encode(flats[p]), m,
    *keys[p], degree, counter_base)``.
    """
    if dispatch.on_cpu(flats, keys):
        return shamir_share_batch_ref(flats, m, keys, cfg, degree=degree,
                                      counter_base=counter_base)
    d = _check_degree(m, degree, cfg)
    check_batch_inputs(flats, m, keys, "shamir_share_batch")
    return shamir_share_batch_cuda(flats, m, keys, cfg, d, counter_base)


def shamir_reconstruct(member_sums, n: int, cfg,
                       points: tuple[int, ...] | None = None,
                       inv_scale: float | None = None):
    """``[k, D]`` field sums at ``points`` -> float32 ``[D]`` mean.

    ``inv_scale`` replaces the unscale factor ``1/scale``: the SPMD path
    passes ``f32(1/(scale*n))`` with ``n = 1``, the reference's jitted
    decode (``fl.spmd``).
    """
    if dispatch.on_cpu(member_sums):
        return shamir_reconstruct_ref(member_sums, n, cfg, points=points,
                                      inv_scale=inv_scale)
    if member_sums.dtype != torch.int32 or member_sums.ndim != 2 \
            or not member_sums.is_contiguous():
        raise ValueError("shamir_reconstruct: member sums must be "
                         "contiguous int32 [k, D], got "
                         f"{member_sums.dtype} {tuple(member_sums.shape)}")
    k = member_sums.shape[0]
    pts = points or tuple(range(1, k + 1))
    if len(pts) != k or k < 1:
        raise ValueError("points/shares length mismatch")
    return shamir_reconstruct_cuda(member_sums,
                                   lagrange_weights_at_zero(tuple(pts)), n,
                                   cfg, inv_scale)
