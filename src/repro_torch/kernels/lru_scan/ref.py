"""Plain PyTorch version of the fused RG-LRU scan.

Counterpart of ``repro/kernels/lru_scan/ref.py::lru_scan_ref``: the
sequential float32 recurrence over channels (Griffin Eq. 4),

    h_t = a_t ⊙ h_{t-1} + b_t,      y_t = h_t

a, b: ``[B, S, W]``  ->  h: ``[B, S, W]`` (all states, float32).

Each step rounds the product ``a_t·h`` before adding ``b_t`` (two
operations, no fused multiply-add), as the CUDA kernel does: a nearly
undamped carry adds up every step's rounding difference, so the two
must round alike to agree over a long sequence.
"""

from __future__ import annotations

import torch


def lru_scan_ref(a, b, h0=None):
    af, bf = a.float(), b.float()
    bsz, s, w = af.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=af.device)
         if h0 is None else h0.float())
    hs = torch.empty((bsz, s, w), dtype=torch.float32, device=af.device)
    for t in range(s):
        h = af[:, t] * h
        h = h + bf[:, t]
        hs[:, t] = h
    return hs
