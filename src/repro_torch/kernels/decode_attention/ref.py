"""Plain PyTorch version of single-token (decode) attention with LSE
partials.

Counterpart of ``repro/kernels/decode_attention/ref.py``.  Given one
query token per sequence against a KV cache (shard), return the
*unnormalized* accumulator and the log-sum-exp statistics

    acc[b,h,:] = Σ_j exp(s_j − m)·v_j,   m = max_j s_j,   l = Σ_j exp(s_j − m)

so that shards of the KV sequence combine exactly (``combine_partials``):

    M = max_i m_i;  out = Σ_i acc_i·e^{m_i−M} / Σ_i l_i·e^{m_i−M}
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, kv_len=None, sm_scale=None):
    """q: ``[B,Hq,D]``, k/v: ``[B,Hkv,S,D]`` -> (acc ``[B,Hq,D]``,
    m ``[B,Hq]``, l ``[B,Hq]``), all float32.

    ``kv_len``: optional valid length (an int or a ``[B]`` tensor);
    positions ``>= kv_len`` are masked (ragged cache).
    """
    b, hq, dd = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dd)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        valid = (torch.arange(s, device=q.device)[None, None, :]
                 < kv_len.reshape(-1, 1, 1))
        scores = torch.where(valid, scores,
                             torch.full((), NEG_INF, device=q.device))
    m = scores.max(dim=-1).values
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    acc = torch.einsum("bhs,bhsd->bhd", e, vv)
    return acc, m, l


def fold_partials(accs, ms, ls):
    """Plain version of the fold kernel: partials of key ranges along a
    leading axis, merged in that axis's order (no atomics, so the order
    is fixed) into unnormalized float32 partials of their union.

    accs: ``[P,B,H,D]``, ms/ls: ``[P,B,H]`` -> (acc ``[B,H,D]``,
    m ``[B,H]``, l ``[B,H]``): ``M = max_i m_i``,
    ``acc = Σ_i acc_i·e^{m_i−M}``, ``l = Σ_i l_i·e^{m_i−M}``.
    """
    m = ms.max(dim=0).values
    acc = torch.zeros_like(accs[0])
    l = torch.zeros_like(ls[0])
    for acc_i, m_i, l_i in zip(accs, ms, ls):
        w = torch.exp(m_i - m)
        acc = acc + acc_i * w[..., None]
        l = l + l_i * w
    return acc, m, l


def combine_partials(accs, ms, ls):
    """Merge shard partials along a leading shard axis.

    accs: ``[P,B,H,D]``, ms/ls: ``[P,B,H]`` -> normalized ``[B,H,D]``.
    """
    acc, _, l = fold_partials(accs, ms, ls)
    return acc / l[..., None]
