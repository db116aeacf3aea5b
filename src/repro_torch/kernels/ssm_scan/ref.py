"""Plain PyTorch version of the fused selective scan (Mamba-1).

Counterpart of ``repro/kernels/ssm_scan/ref.py::ssm_scan_ref``: the
sequential float32 recurrence, the ground truth the CUDA kernel and the
model's chunked scan are held to,

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
    y_t = Σ_n h_t[·, n] · C_t[n]

x, dt: ``[B, S, di]``;  B, C: ``[B, S, st]``;  A: ``[di, st]``  ->
y: ``[B, S, di]`` (float32).
"""

from __future__ import annotations

import torch


def ssm_scan_ref(x, dt, bc, cc, a):
    xf, dtf, bcf, ccf, af = (t.float() for t in (x, dt, bc, cc, a))
    bsz, s, di = xf.shape
    h = torch.zeros((bsz, di, af.shape[-1]), dtype=torch.float32,
                    device=xf.device)
    ys = torch.empty((bsz, s, di), dtype=torch.float32, device=xf.device)
    for t in range(s):
        dtt = dtf[:, t]
        da = torch.exp(dtt[..., None] * af[None])                # [B,di,st]
        h = da * h + (dtt * xf[:, t])[..., None] * bcf[:, t, None, :]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, ccf[:, t])
    return ys
