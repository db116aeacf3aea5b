"""Building-block layers: norms, rotary embeddings, MLPs, losses.

Counterpart of ``repro/models/layers.py``: functions over explicit
parameter dicts in the reference's layout (a linear weight is
``[in, out]`` and applied as ``x @ w``), with the reference's float
sequence — norms and rotary embeddings in float32, matrix products in
the compute dtype.  Initializers draw from an explicit
``torch.Generator`` (the numbers differ from JAX's; the tests carry the
reference's weights across instead).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import ArchConfig, shard


def _normal(gen: torch.Generator, shape, dtype, device, scale: float):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """Float32 statistics: the mean, the population variance (``jnp.var``)
    and ``rsqrt``, as the reference's."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def norm_init(cfg: ArchConfig, dtype, device=None):
    return (rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init)(
        cfg.d_model, dtype, device)


def apply_norm(cfg: ArchConfig, params, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(params, x, cfg.norm_eps)
    return layernorm(params, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


def apply_rope(x, positions, theta: float = 1e4):
    """x: ``[B, H, S, D]``; positions: ``[B, S]``.  One position stream:
    the reference's ``_project_qkv`` never passes M-RoPE's sections, so
    qwen2-vl's ``rope="mrope"`` is this rotation in both packages."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                     # [D/2]
    angles = positions[:, None, :, None].float() * freqs        # [B,1,S,D/2]
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int):
    """Whisper's encoder positions ``[seq, d]`` float32, computed in numpy
    as the reference's, so both packages hold the same bits."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out)


# ---------------------------------------------------------------------------
# Dense MLP: gated (SiLU, or GeGLU), or biased and ungated (gelu)
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``: the tanh approximation by default (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype, device=None,
             d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    scale_in = 1.0 / np.sqrt(d)
    scale_out = 1.0 / np.sqrt(f)
    if cfg.act in ("silu", "geglu"):
        return {
            "w_gate": _normal(gen, (d, f), dtype, device, scale_in),
            "w_up": _normal(gen, (d, f), dtype, device, scale_in),
            "w_down": _normal(gen, (f, d), dtype, device, scale_out),
        }
    return {
        "w_up": _normal(gen, (d, f), dtype, device, scale_in),
        "b_up": torch.zeros((f,), dtype=dtype, device=device),
        "w_down": _normal(gen, (f, d), dtype, device, scale_out),
        "b_down": torch.zeros((d,), dtype=dtype, device=device),
    }


def mlp_apply(params, x, cfg: ArchConfig):
    cd = x.dtype
    if cfg.act in ("silu", "geglu"):
        gate = x @ params["w_gate"].to(cd)
        up = x @ params["w_up"].to(cd)
        gate = shard(gate, "batch", "seq", "ff")
        act = F.silu(gate) if cfg.act == "silu" else gelu(gate)
        return (act * up) @ params["w_down"].to(cd)
    h = x @ params["w_up"].to(cd) + params["b_up"].to(cd)
    h = shard(h, "batch", "seq", "ff")
    return gelu(h) @ params["w_down"].to(cd) + params["b_down"].to(cd)


# ---------------------------------------------------------------------------
# Embedding + chunked cross-entropy
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype,
                   device=None):
    return {"table": _normal(gen, (vocab, d), dtype, device, 0.02)}


def embed(params, tokens, compute_dtype):
    return params["table"].to(compute_dtype)[tokens]


def chunked_softmax_xent(x, w_vocab, labels, *, chunk: int = 1024,
                         label_mask=None):
    """Cross-entropy over a large vocab without materializing ``[B,S,V]``.

    A loop over sequence chunks: each chunk's logits live only in its
    iteration, bounding the logits at ``B·chunk·V`` (at vocab 151,936 the
    full float32 logits of a long sequence would take tens of GB).

    x: ``[B, S, d]``; w_vocab: ``[d, V]``; labels: ``[B, S]``.  Returns
    the mean NLL over unmasked positions.
    """
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if label_mask is None:
        label_mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    w = w_vocab.to(x.dtype)
    for lo in range(0, s, chunk):
        xc = x[:, lo:lo + chunk]
        yc = labels[:, lo:lo + chunk]
        mc = label_mask[:, lo:lo + chunk].float()
        logits = (xc @ w).float()
        logits = shard(logits, "batch", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        nll = (lse - gold) * mc
        total = total + nll.sum()
        count = count + mc.sum()
    return total / torch.clamp(count, min=1.0)
