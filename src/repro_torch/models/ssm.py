"""Mamba-1 selective-SSM block (falcon-mamba-7b architecture).

Counterpart of ``repro/models/ssm.py``: in_proj -> causal depthwise conv
-> selective SSM -> gated out_proj, over explicit parameter dicts in the
reference's layout.

The selective scan takes one of two paths (``ssm_block_apply``), as the
attention rule does (``models/attention.py``):

* the fused kernel (``kernels/ssm_scan``) for ``impl="auto"`` on a CUDA
  tensor while autograd does not record, or ``impl="pallas"``; as the
  reference's TPU path, its output comes back in x's dtype and is then
  cast to float32 (``repro/models/ssm.py:78-79``);
* otherwise, and always for ``impl="dense"``, the chunked scan
  (``scan_utils.chunked_linear_scan``) in ``cfg.scan_dtype``, as the
  reference's other path (``:81-88``).  It materializes the
  ``[B, S, di, st]`` states.

Decode (``ssm_block_step``) is O(1) a token and carries
``conv [B, k-1, di]`` and ``ssm [B, di, st]``, both float32.  It
computes the reference's function, dtypes included: the float32 conv
state promotes the rest of the step to float32 against weights rounded
to the compute dtype, until ``y`` is cast back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import records_grad
from repro_torch.kernels.ssm_scan import ssm_scan
from .common import ArchConfig, shard
from .scan_utils import chunked_linear_scan

SCAN_UNDER_AUTOGRAD = (
    "impl='pallas' under autograd is not ported yet: the selective-scan "
    "kernel has no backward, nor can the reference's be differentiated "
    "(ROADMAP queue 3, finding 5); training runs the chunked scan")


def ssm_block_init(gen, cfg: ArchConfig, dtype, device=None):
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, kc = cfg.dt_rank, cfg.ssm_conv

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * scale

    a_init = torch.arange(1, st + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": normal((d, 2 * di), 1.0 / np.sqrt(d)),
        "conv_w": normal((kc, di), 0.2),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal((di, dtr + 2 * st), 1.0 / np.sqrt(di)),
        "dt_proj": normal((dtr, di), 1.0 / np.sqrt(dtr)),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype,
                              device=device),  # softplus^-1(0.01)
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": normal((di, d), 1.0 / np.sqrt(di)),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches
    to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w, b):
    """x: ``[B,S,di]``; w: ``[k,di]`` depthwise causal conv along S."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_dbc(dbc, cfg: ArchConfig):
    """dt, B, C of ``x_proj``'s output (``jnp.split`` at the cut points
    ``[dt_rank, dt_rank + st]`` is ``torch.split`` by sizes)."""
    st = cfg.ssm_state
    return torch.split(dbc, [cfg.dt_rank, st, st], dim=-1)


def ssm_block_apply(params, x, cfg: ArchConfig, chunk: int = 64,
                    impl: str = "auto"):
    """x: ``[B, S, d]`` -> ``[B, S, d]`` (training / prefill path)."""
    cd = x.dtype
    xz = x @ params["in_proj"].to(cd)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in = shard(x_in, "batch", "seq", "ff")
    x_c = F.silu(_causal_conv(x_in, params["conv_w"].to(cd),
                              params["conv_b"].to(cd)))

    dbc = x_c @ params["x_proj"].to(cd)
    dt, bc, cc = _split_dbc(dbc, cfg)
    dt = softplus((dt @ params["dt_proj"].to(cd)).float()
                  + params["dt_bias"].float())                # [B,S,di]
    a = -torch.exp(params["A_log"])                           # [di,st] f32

    x_f = x_c.float()
    recording = records_grad(x_c, dt, bc, cc, a)
    if impl == "auto":
        impl = ("pallas" if x_c.device.type == "cuda" and not recording
                else "dense")
    if impl == "pallas":
        # the fused kernel: the [B,S,di,st] states never reach memory
        if recording:
            raise NotImplementedError(SCAN_UNDER_AUTOGRAD)
        y = ssm_scan(x_c, dt, bc, cc, a).float()
    elif impl in ("dense", "xla_chunked"):
        sdt = (torch.bfloat16 if cfg.scan_dtype == "bfloat16"
               else torch.float32)
        da = torch.exp(dt[..., None] * a[None, None]).to(sdt)
        dbx = ((dt * x_f)[..., None]
               * bc.float()[:, :, None, :]).to(sdt)
        hs, _ = chunked_linear_scan(da, dbx, chunk=chunk)    # [B,S,di,st]
        y = torch.einsum("bsdn,bsn->bsd", hs.float(), cc.float())
    else:
        raise ValueError(f"unknown SSM impl {impl!r}")
    y = y + x_f * params["D"][None, None, :]
    y = y.to(cd) * F.silu(z)
    return y @ params["out_proj"].to(cd)


def ssm_init_state(cfg: ArchConfig, batch: int, device=None):
    """Zeroed decode state, both float32 (the reference gives the SSM
    states no other dtype)."""
    di, st, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, di), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((batch, di, st), dtype=torch.float32,
                           device=device),
    }


def _rounded(w, cd, like):
    """``w`` rounded to the compute dtype, then in ``like``'s dtype: jnp
    promotes a ``w.astype(cd)`` operand to the other operand's float32;
    ``torch.matmul`` takes no mixed dtypes, so the port casts."""
    return w.to(cd).to(like.dtype)


def ssm_block_step(params, x, state, cfg: ArchConfig):
    """Single-token decode.  x: ``[B, d]`` -> (``[B, d]``, new state).

    ``state``'s tensors are updated in place (the reference returns new
    ones) and returned."""
    cd = x.dtype
    xz = x @ params["in_proj"].to(cd)
    x_in, z = torch.chunk(xz, 2, dim=-1)                      # [B, di]

    # the float32 state promotes the buffer, and from here the step runs
    # in float32 as jnp's promotion runs it
    conv_buf = torch.cat([state["conv"],
                          x_in[:, None, :].to(state["conv"].dtype)], dim=1)
    w = _rounded(params["conv_w"], cd, conv_buf)              # [k, di]
    x_c = torch.einsum("bkd,kd->bd", conv_buf, w) \
        + _rounded(params["conv_b"], cd, conv_buf)
    x_c = F.silu(x_c)

    dbc = x_c @ _rounded(params["x_proj"], cd, x_c)
    dt, bc, cc = _split_dbc(dbc, cfg)
    dt = softplus((dt @ _rounded(params["dt_proj"], cd, dt)).float()
                  + params["dt_bias"].float())                # [B, di]
    a = -torch.exp(params["A_log"])                           # [di, st]
    da = torch.exp(dt[..., None] * a[None])                   # [B, di, st]
    x_f = x_c.float()
    dbx = (dt * x_f)[..., None] * bc.float()[:, None, :]
    h = da * state["ssm"] + dbx                               # [B, di, st]
    y = torch.einsum("bdn,bn->bd", h, cc.float())
    y = y + x_f * params["D"][None, :]
    y = (y.to(cd) * F.silu(z)) @ params["out_proj"].to(cd)
    state["conv"].copy_(conv_buf[:, 1:])
    state["ssm"].copy_(h)
    return y, state
