"""Attention: the dense, chunked (online-softmax) and flash-kernel paths.

Counterpart of ``repro/models/attention.py``, with three
implementations behind one entry point:

* ``pallas`` — the flash kernel (``kernels/flash_attention``): the CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor.  It has no
  backward, as the reference's has none (ROADMAP queue 3, finding 1):
  while autograd records, ``impl="pallas"`` raises and ``"auto"`` does
  not pick it, so the train step runs ``dense`` / ``xla_chunked``;
* ``xla_chunked`` — a loop over KV blocks with the streaming-softmax
  recurrence: the same ``O(Sq·block)`` score footprint;
* ``dense`` — materialized scores: the flash kernel's plain version
  (``kernels/flash_attention/ref.py::attention_ref``).

``"auto"`` is the reference's rule with the card in the TPU's place:
the flash kernel on a CUDA tensor while autograd does not record (the
reference also asks for lengths that divide by 128, which its TPU tiling
needs and the CUDA kernel does not); else ``xla_chunked`` for long
sequences and ``dense`` for short ones.  Decode goes through
``kernels/decode_attention`` (``models/transformer.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.ops import records_grad
from .common import ArchConfig

NEG_INF = -1e30

FLASH_UNDER_AUTOGRAD = (
    "impl='pallas' under autograd is not ported yet: the flash kernel has "
    "no backward, nor has the reference's (ROADMAP queue 3, finding 1); "
    "training runs 'dense' or 'xla_chunked'")


def _mask(q_idx, k_idx, causal: bool, window: int):
    """True where a key is masked: above the causal diagonal, or at or
    below ``q - window`` (the reference's ``xla_chunked_attention``)."""
    mask = torch.zeros((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool,
                       device=q_idx.device)
    if causal:
        mask = mask | (k_idx[None, :] > q_idx[:, None])
    if window and window > 0:
        mask = mask | (k_idx[None, :] <= q_idx[:, None] - window)
    return mask


def xla_chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                          sm_scale: float | None = None,
                          block_k: int = 512):
    """Streaming-softmax attention over KV blocks of ``block_k``.

    q: ``[B,H,Sq,D]``; k/v: ``[B,Hkv,Skv,D]``.  Scores take
    ``O(Sq·block_k)`` per head instead of ``O(Sq·Skv)``.  ``window > 0``
    masks the keys at or below ``q - window``, as the reference's.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(d)
    block_k = min(block_k, skv)
    if skv % block_k:
        raise ValueError(f"{skv} keys are not a multiple of {block_k}")
    qf = q.float() * scale
    offs = skv - sq if causal else 0
    q_idx = torch.arange(sq, device=q.device) + offs
    m_prev = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                        device=q.device)
    l_prev = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, block_k):
        kc = k[:, :, lo:lo + block_k].float()
        vc = v[:, :, lo:lo + block_k].float()
        if group > 1:
            kc = kc.repeat_interleave(group, dim=1)
            vc = vc.repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc)
        k_idx = lo + torch.arange(block_k, device=q.device)
        s = torch.where(_mask(q_idx, k_idx, causal, window)[None, None],
                        torch.full((), NEG_INF, device=q.device), s)
        m_new = torch.maximum(m_prev, s.max(dim=-1).values)
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        l_prev = l_prev * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m_prev = m_new
    l_prev = torch.where(l_prev == 0.0, torch.ones_like(l_prev), l_prev)
    return (acc / l_prev[..., None]).to(q.dtype)


def attention(q, k, v, cfg: ArchConfig, *, causal: bool = True,
              impl: str = "auto", block_k: int = 512):
    """Dispatching attention entry point.  q:``[B,H,Sq,D]``
    k/v:``[B,Hkv,Skv,D]``."""
    skv = k.shape[2]
    recording = records_grad(q, k, v)
    if impl == "auto":
        if q.device.type == "cuda" and not recording:
            impl = "pallas"
        elif skv >= 1024 and skv % 512 == 0:
            impl = "xla_chunked"
        else:
            impl = "dense"
    if impl == "pallas":
        if recording:
            raise NotImplementedError(FLASH_UNDER_AUTOGRAD)
        return flash_attention(q, k, v, causal=causal, window=cfg.window)
    if impl == "xla_chunked":
        return xla_chunked_attention(q, k, v, causal=causal,
                                     window=cfg.window, block_k=block_k)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    return attention_ref(q, k, v, causal=causal,
                         window=cfg.window).to(q.dtype)
