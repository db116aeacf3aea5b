"""AdamW over nested dicts of tensors, with fp32 moments.

Counterpart of ``repro/optim/adamw.py``: ``adamw_init(params) ->
state``; ``adamw_update(grads, state, params, step) -> (params, state)``
with the reference's float32 sequence — the global-norm clip, the bias
corrections ``1 - b**t`` in float32, ``(m/bc1) / (sqrt(v/bc2) + eps)``
and the decoupled weight decay.  The port updates in place: the
parameters and moments passed in are overwritten (under ``no_grad``)
and returned, which saves a copy of the model and both moments.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import flatten_with_path, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``(grads * min(1, max_norm / max(norm, 1e-12)), norm)``, float32.

    ``norm``: the global norm when ``grads`` holds only a part of the
    gradient (a party's shards under MPC-FSDP); default their own."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_init(params):
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)}


@torch.no_grad()
def adamw_update(grads, state, params, step: int, cfg: AdamWConfig,
                 norm=None):
    """One AdamW step at ``step`` (0-based); updates in place.  ``norm``
    as in ``clip_by_global_norm``."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip, norm=norm)
    # the bias corrections in float32 on the host, then as 0-d tensors
    # filled on the parameters' device: an IEEE division by a tensor (a
    # CUDA tensor divided by a Python float is a reciprocal multiply),
    # and no copy from host memory that would wait for the card
    t = torch.tensor(float(step + 1), dtype=torch.float32)
    bc = [float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
          for b in (cfg.b1, cfg.b2)]
    consts: dict = {}
    g_by_path = dict(flatten_with_path(grads))
    m_by_path = dict(flatten_with_path(state["m"]))
    v_by_path = dict(flatten_with_path(state["v"]))
    for path, p in flatten_with_path(params):
        g, m, v = g_by_path[path], m_by_path[path], v_by_path[path]
        if p.device not in consts:
            consts[p.device] = [torch.full((), c, dtype=torch.float32,
                                           device=p.device) for c in bc]
        bc1, bc2 = consts[p.device]
        pf = p.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = pf - cfg.lr * (update + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    return params, state
