"""Griffin / RecurrentGemma recurrent block: RG-LRU behind a causal conv.

Counterpart of ``repro/models/hybrid.py``.  recurrentgemma-9b stacks
repeating (rec, rec, local-attn) triads and two trailing rec layers
(``models/transformer.py::stack_plan``); this module is the rec block,
Griffin's dual-branch gated design ``merge(GeLU(W_g x) ⊙
RG-LRU(conv1d(W_x x)))``, over explicit parameter dicts in the
reference's layout.

RG-LRU (Griffin Eq. 2-4, c = 8):
    r_t = σ(W_a x_t);  i_t = σ(W_i x_t)
    a_t = exp(−c·softplus(Λ)·r_t)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates run in float32 whatever the compute dtype, so the scan's a and
b are float32.  The scan takes one of two paths (``rglru_apply``), as
the SSM block's does (``models/ssm.py``):

* the fused kernel (``kernels/lru_scan``) for ``impl="auto"`` on a CUDA
  tensor with no initial state while autograd does not record, or
  ``impl="pallas"``; its states come back in a's dtype, and the block
  returns them in x's dtype and the last one in float32, as the
  reference's TPU path (``repro/models/hybrid.py:63-68``);
* otherwise, and always for ``impl="dense"``, the chunked scan
  (``scan_utils.chunked_linear_scan``), as the reference's other path
  (``:69-70``).

The gelu is ``jax.nn.gelu``'s tanh form (``layers.gelu``).  Decode
(``rec_block_step``) carries ``conv [B, 3, W]`` and ``h [B, W]``, both
float32; as the reference's, it casts the conv state to the compute
dtype before the conv (and back on store), and keeps h in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import records_grad
from repro_torch.kernels.lru_scan import lru_scan
from .common import ArchConfig, shard
from .layers import _normal, gelu
from .scan_utils import chunked_linear_scan
from .ssm import _causal_conv, softplus

_C = 8.0  # Griffin's fixed recurrence sharpness

SCAN_UNDER_AUTOGRAD = (
    "impl='pallas' under autograd is not ported yet: the RG-LRU scan "
    "kernel has no backward, nor can the reference's be differentiated "
    "(ROADMAP queue 3, finding 5); training runs the chunked scan")


def rglru_init(gen, width: int, dtype, device=None):
    s = 1.0 / np.sqrt(width)
    # Λ so that a ∈ [0.9, 0.999] at r = 1 (Griffin appendix A), float32
    grid = torch.linspace(0.9, 0.999, width, dtype=torch.float32,
                          device=device)
    lam = torch.log(torch.expm1(-torch.log(grid) / _C))
    return {
        "w_a": _normal(gen, (width, width), dtype, device, s),
        "b_a": torch.zeros((width,), dtype=dtype, device=device),
        "w_i": _normal(gen, (width, width), dtype, device, s),
        "b_i": torch.zeros((width,), dtype=dtype, device=device),
        "lambda": lam,
    }


def _rglru_gates(params, x):
    """a (the decay) and b (the gated input) of the recurrence, both
    float32."""
    cd = x.dtype
    r = torch.sigmoid((x @ params["w_a"].to(cd)
                       + params["b_a"].to(cd)).float())
    i = torch.sigmoid((x @ params["w_i"].to(cd)
                       + params["b_i"].to(cd)).float())
    log_a = -_C * softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, gated


def rglru_apply(params, x, chunk: int = 64, h0=None, impl: str = "auto"):
    """x: ``[B, S, W]`` -> (``[B, S, W]`` of x's dtype, h_last ``[B, W]``
    float32)."""
    a, b = _rglru_gates(params, x)
    recording = records_grad(a, b)
    if impl == "auto":
        impl = ("pallas" if h0 is None and not recording
                and not dispatch.on_cpu(a, b) else "dense")
    if impl == "pallas":
        # the fused kernel: the carry stays in a register
        if recording:
            raise NotImplementedError(SCAN_UNDER_AUTOGRAD)
        if h0 is not None:
            raise ValueError("the RG-LRU scan kernel starts from h = 0, as "
                             "the reference's; pass impl='dense' with h0")
        hs = lru_scan(a, b)
        return hs.to(x.dtype), hs[:, -1].float()
    if impl not in ("dense", "xla_chunked"):
        raise ValueError(f"unknown RG-LRU impl {impl!r}")
    hs, h_last = chunked_linear_scan(a, b, h0=h0, chunk=chunk)
    return hs.to(x.dtype), h_last


def rglru_step(params, x, h):
    """x: ``[B, W]``, h: ``[B, W]`` float32 -> (y ``[B, W]`` of x's dtype,
    h' ``[B, W]`` float32)."""
    a, b = _rglru_gates(params, x[:, None, :])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x.dtype), h_new


def rec_block_init(gen, cfg: ArchConfig, dtype, device=None):
    d = cfg.d_model
    w = cfg.lru_width or d
    s = 1.0 / np.sqrt(d)
    sw = 1.0 / np.sqrt(w)
    return {
        "w_gate": _normal(gen, (d, w), dtype, device, s),
        "w_x": _normal(gen, (d, w), dtype, device, s),
        "conv_w": _normal(gen, (4, w), dtype, device, 0.2),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "lru": rglru_init(gen, w, dtype, device),
        "w_out": _normal(gen, (w, d), dtype, device, sw),
    }


def rec_block_apply(params, x, cfg: ArchConfig, chunk: int = 64,
                    impl: str = "auto"):
    """Griffin recurrent block, full sequence.  x: ``[B, S, d]``."""
    cd = x.dtype
    gate = gelu(x @ params["w_gate"].to(cd))
    u = x @ params["w_x"].to(cd)
    u = shard(u, "batch", "seq", "ff")
    u = _causal_conv(u, params["conv_w"].to(cd), params["conv_b"].to(cd))
    y, _ = rglru_apply(params["lru"], u, chunk=chunk, impl=impl)
    return (gate * y) @ params["w_out"].to(cd)


def rec_init_state(cfg: ArchConfig, batch: int, device=None):
    """Zeroed decode state, both float32 (the reference's default)."""
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, 3, w), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rec_block_step(params, x, state, cfg: ArchConfig):
    """Single-token decode for the recurrent block.  x: ``[B, d]`` ->
    (``[B, d]``, state).

    ``state``'s tensors are updated in place (the reference returns new
    ones) and returned."""
    cd = x.dtype
    gate = gelu(x @ params["w_gate"].to(cd))
    u = x @ params["w_x"].to(cd)
    conv_buf = torch.cat([state["conv"].to(cd), u[:, None, :]], dim=1)
    w = params["conv_w"].to(cd)
    u_c = torch.einsum("bkd,kd->bd", conv_buf, w) + params["conv_b"].to(cd)
    y, h_new = rglru_step(params["lru"], u_c, state["h"])
    out = (gate * y) @ params["w_out"].to(cd)
    state["conv"].copy_(conv_buf[:, 1:])
    state["h"].copy_(h_new)
    return out, state
