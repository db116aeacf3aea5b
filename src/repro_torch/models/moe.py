"""Mixture-of-Experts FFN with capacity-bounded top-k dispatch.

Counterpart of ``repro/models/moe.py``: functions over an explicit
parameter dict in the reference's layout (``router [d, E]`` float32,
``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]``), computing what the
reference computes, step for step:

  1. router logits in float32 -> the top ``k`` experts of each token
     (descending, ties to the lowest index, as ``jax.lax.top_k``: a
     stable descending sort; ``torch.topk`` does not promise the order)
     and the softmax of their logits;
  2. each assignment's position in its expert, from a cumulative count
     one routing rank at a time (``moe_dispatch="cumsum"``: rank ``r``
     before rank ``r + 1``) or from a stable sort of the flat
     assignments (``"sort"``: token-major priority); assignments at or
     past the capacity drop and go to the overflow slot ``E·cap``;
  3. the tokens gathered into per-expert buffers ``[E, cap, d]``;
  4. batched expert GEMMs ``[E, cap, d] × [E, d, f]`` in the compute
     dtype, the weights cast to it on every call, as the reference's;
  5. the combine in float32, weighted by ``gates · keep``.

The capacity is ``max(8, round_up_8(ceil(T·k/E·cf)))``, from host ints.
Nothing on the device path waits for the host: no boolean-mask indexing
(the overflow row takes the dropped assignments), no ``.item()``, no
``bincount`` or ``one_hot`` (both read the data's maximum on the card).
The reference runs these steps outside any Pallas kernel, and so does
the port: the GEMMs are ``torch.bmm``.

``record_routing`` collects each call's routing while it is active
(router logits, expert choices, ``keep``), and ``force_routing`` makes
the calls take given expert choices: the checks that hold two paths
against each other read the one and run the second path under the first
path's routing, so that the two differ only as continuous functions do
(a token at a near-tie of its router logits may otherwise take another
expert on one path, a discrete change).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .common import ArchConfig, shard

#: the routings collected by each active ``record_routing``
_RECORDERS: list[list] = []
#: the expert choices each active ``force_routing`` hands out, in order
_FORCED: list = []


@contextlib.contextmanager
def record_routing():
    """While active, every ``moe_apply`` call appends ``{"logits": [T, E]
    float32, "eidx": [T, k], "keep": [T, k] bool, "own": [T, k]}``
    (copies) to the list it yields, in call order: one entry a MoE layer
    a forward.  ``eidx`` is the routing the call used, ``own`` its own
    top k (they differ under ``force_routing``)."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


@contextlib.contextmanager
def force_routing(eidxs):
    """While active, the i-th ``moe_apply`` call routes its tokens to
    ``eidxs[i]`` (``[T, k]``) instead of its own top k, gated by the
    softmax of its own logits at those experts; positions and drops
    follow from them as usual."""
    it = iter(eidxs)
    _FORCED.append(it)
    try:
        yield
    finally:
        _FORCED.remove(it)


def moe_init(gen, cfg: ArchConfig, dtype, device=None):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    si, so = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)

    def normal(shape, dt, scale):
        # scaled in place: an expert stack of grok-1-314b is 6.4 GB
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(scale)

    return {"router": normal((d, e), torch.float32, si),
            "w_gate": normal((e, d, f), dtype, si),
            "w_up": normal((e, d, f), dtype, si),
            "w_down": normal((e, f, d), dtype, so)}


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots an expert holds for ``t`` tokens: ``ceil(t·k/E·cf)`` rounded
    up to a multiple of 8, at least 8 (the reference's expression)."""
    cap = int(np.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def route(params, xt, cfg: ArchConfig):
    """Router logits ``[T, E]`` (float32), the softmaxed gates ``[T, k]``
    and the expert ids ``[T, k]`` of tokens ``xt [T, d]``."""
    logits = xt.float() @ params["router"].float()
    # jax.lax.top_k: descending, the lower index first among equals
    top, eidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    gates = torch.softmax(top[:, :k], dim=-1)
    return logits, gates, eidx[:, :k]


def positions(eidx, cap: int, cfg: ArchConfig):
    """Each flat assignment's position in its expert ``[T·k]`` and whether
    it fits the capacity ``[T·k]``, under ``cfg.moe_dispatch``."""
    t, k = eidx.shape
    e = cfg.n_experts
    flat_e = eidx.reshape(-1)
    if cfg.moe_dispatch == "sort":
        # a stable argsort of the assignment keys: token-major priority
        order = torch.sort(flat_e, stable=True).indices
        counts = torch.zeros((e,), dtype=torch.int64, device=eidx.device)
        counts.index_add_(0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        pos_sorted = (torch.arange(t * k, device=eidx.device)
                      - starts[flat_e[order]])
        pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
        return pos, pos < cap
    # one routing rank at a time, so rank r has priority over rank r + 1.
    # The one-hot is built transposed, [E, T] (a comparison: no read of
    # the data's maximum), so the count runs along its contiguous dim:
    # the same integers as the reference's cumsum over T, which along a
    # strided dim takes 3.6 ms a rank on the H100 at T = 16,384, E = 128
    experts = torch.arange(e, device=eidx.device)[:, None]
    carry = torch.zeros((e, 1), dtype=torch.int32, device=eidx.device)
    cols = []
    for r in range(k):
        oh = (eidx[:, r][None, :] == experts).to(torch.int32)    # [E, T]
        before = torch.cumsum(oh, 1, dtype=torch.int32) - oh + carry
        # each token's count in its own expert's row
        cols.append(torch.gather(before, 0, eidx[:, r][None, :])[0])
        carry = carry + torch.sum(oh, dim=1, keepdim=True,
                                  dtype=torch.int32)
    pos = torch.stack(cols, dim=1).reshape(-1).to(torch.int64)
    return pos, pos < cap


def moe_apply(params, x, cfg: ArchConfig):
    """x: ``[B, S, d]`` -> ``[B, S, d]``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)

    # --- routing ---------------------------------------------------------
    logits, gates, own = route(params, xt, cfg)
    eidx = own
    if _FORCED:
        eidx = next(_FORCED[-1]).to(own.device)
        gates = torch.softmax(torch.gather(logits, 1, eidx), dim=-1)
    pos, keep = positions(eidx, cap, cfg)
    flat_e = eidx.reshape(-1)
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))        # overflow slot
    for rec in _RECORDERS:
        rec.append({"logits": logits.detach().clone(),
                    "eidx": eidx.clone(), "keep": keep.reshape(t, k),
                    "own": own.clone()})

    # --- dispatch gather ---------------------------------------------------
    tok_of_assign = torch.arange(t * k, device=x.device) // k
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=x.device)
    # the dropped assignments all land on the overflow row, cut next
    buf.index_put_((slot,), xt[tok_of_assign])
    buf = buf[:-1].reshape(e, cap, d)
    buf = shard(buf, "experts", None, "embed")

    # --- expert GEMMs -------------------------------------------------------
    cd = xt.dtype
    gate_h = torch.bmm(buf, params["w_gate"].to(cd))
    up_h = torch.bmm(buf, params["w_up"].to(cd))
    gate_h = shard(gate_h, "experts", None, "expert_ff")
    h = F.silu(gate_h) * up_h
    del gate_h, up_h
    out_buf = torch.bmm(h, params["w_down"].to(cd))

    # --- combine scatter ----------------------------------------------------
    out_flat = torch.cat([out_buf.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=cd, device=x.device)])
    per_assign = out_flat[slot]                               # [T*k, d]
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None]
    per_assign = per_assign.float() * w
    out = torch.sum(per_assign.reshape(t, k, d), dim=1)
    return out.to(x.dtype).reshape(b, s, d)


def aux_load_balance_loss(logits, eidx, e: int):
    """Switch-style auxiliary loss (fraction·probability product)."""
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(e, device=eidx.device)
    frac = torch.mean((eidx[..., 0, None] == experts).float(), dim=0)
    prob = torch.mean(probs, dim=0)
    return e * torch.sum(frac * prob)
