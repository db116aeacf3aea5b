"""Plain PyTorch version of blockwise (flash) attention with GQA.

Counterpart of ``repro/kernels/flash_attention/ref.py::attention_ref``:
``softmax(q·kᵀ·scale + mask)·v`` with

* grouped KV heads (``Hq = group·Hkv``; head ``h`` reads KV head
  ``h // group``),
* optional causal masking, the diagonal aligning the **last** query with
  the **last** key (query ``i`` sits at position ``i + Skv − Sq``),
* an optional sliding window (``window > 0``: key ``j`` is visible to
  query ``i`` iff ``i − window < j ≤ i`` in causal mode; without causal
  masking only the lower edge applies).

Masked scores take the finite ``NEG_INF``, as in the reference.  A row
that sees no key at all returns 0, as the CUDA kernel gives it (its
``l == 0`` rule, the Pallas kernel's ``:99-101``); the reference's dense
oracle would average every ``v`` there instead.  No causal prefill or
decode shape has such a row (``Sq ≤ Skv``).  The output is float32.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible_mask(sq: int, skv: int, causal: bool, window: int, device):
    """Boolean ``[Sq, Skv]``: True where query ``i`` may see key ``j``."""
    q_idx = torch.arange(sq, device=device)[:, None] + (skv - sq
                                                        if causal else 0)
    k_idx = torch.arange(skv, device=device)[None, :]
    visible = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        visible = visible & (k_idx <= q_idx)
    if window and window > 0:
        visible = visible & (k_idx > q_idx - window)
    return visible


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  sm_scale: float | None = None):
    """q: ``[B,Hq,Sq,D]``, k/v: ``[B,Hkv,Skv,D]`` -> ``[B,Hq,Sq,D]``
    (float32)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} KV heads")
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(group, dim=1) if group > 1 else k
    vv = v.repeat_interleave(group, dim=1) if group > 1 else v
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    visible = visible_mask(sq, skv, causal, window, q.device)[None, None]
    s = torch.where(visible, s, torch.full((), NEG_INF, device=q.device))
    m = s.max(dim=-1, keepdim=True).values
    e = torch.where(visible, torch.exp(s - m),
                    torch.zeros((), device=q.device))
    den = e.sum(dim=-1, keepdim=True)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return torch.einsum("bhqk,bhkd->bhqd", e, vv.float()) / den
