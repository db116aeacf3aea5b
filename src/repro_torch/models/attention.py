"""Attention for training: the dense and chunked (online-softmax) paths.

Counterpart of ``repro/models/attention.py``.  The reference dispatches
between three implementations; the port has two of them:

* ``dense`` — materialized scores, the plain version of the reference's
  flash kernel (``kernels/flash_attention/ref.py::attention_ref``);
* ``xla_chunked`` — a loop over KV blocks with the streaming-softmax
  recurrence: the same ``O(Sq·block)`` score footprint;
* ``pallas`` — the flash kernel.  The reference cannot differentiate it
  (``jax.grad`` through ``flash_attention_pallas`` raises in Pallas's JVP
  rule), so its train step never runs it; the port's kernel comes with
  the prefill slice, where it runs forward only.  ``impl="pallas"``
  raises and ``"auto"`` never picks it.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import ArchConfig

NEG_INF = -1e30

FLASH_LATER = ("impl='pallas' is not ported yet: flash_attention_pallas is "
               "ROADMAP queue 2, item 3, and comes with the prefill and "
               "serving slice (queue 1, item 1); training runs 'dense' or "
               "'xla_chunked'")


def _mask(q_idx, k_idx, causal: bool):
    if causal:
        return k_idx[None, :] > q_idx[:, None]
    return torch.zeros((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool,
                       device=q_idx.device)


def dense_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q: ``[B,Hq,Sq,D]``, k/v: ``[B,Hkv,Skv,D]`` -> ``[B,Hq,Sq,D]``
    (float32): ``softmax(q·kᵀ·scale + mask)·v`` with grouped KV heads and
    causal masking aligned at the last key."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} KV heads")
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(d)
    kk = k.repeat_interleave(group, dim=1) if group > 1 else k
    vv = v.repeat_interleave(group, dim=1) if group > 1 else v
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    q_idx = torch.arange(sq, device=q.device) + (skv - sq if causal else 0)
    k_idx = torch.arange(skv, device=q.device)
    s = torch.where(_mask(q_idx, k_idx, causal)[None, None],
                    torch.full((), NEG_INF, device=q.device), s)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    out = torch.einsum("bhqk,bhkd->bhqd", e, vv.float())
    return out / e.sum(dim=-1, keepdim=True)


def xla_chunked_attention(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None,
                          block_k: int = 512):
    """Streaming-softmax attention over KV blocks of ``block_k``.

    q: ``[B,H,Sq,D]``; k/v: ``[B,Hkv,Skv,D]``.  Scores take
    ``O(Sq·block_k)`` per head instead of ``O(Sq·Skv)``.
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
        s = torch.where(_mask(q_idx, k_idx, causal)[None, None],
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
    if impl == "auto":
        impl = ("xla_chunked" if skv >= 1024 and skv % 512 == 0
                else "dense")
    if impl == "pallas":
        raise NotImplementedError(FLASH_LATER)
    if impl == "xla_chunked":
        return xla_chunked_attention(q, k, v, causal=causal,
                                     block_k=block_k)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    return dense_attention(q, k, v, causal=causal).to(q.dtype)
