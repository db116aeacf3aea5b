"""The paper's models: SimpleNN (121->2, s=242) and ComplexNN
(121->60->2, s=7380) for the fault-detection use case (paper §IV-A).

Counterpart of ``repro/models/simple_nn.py``.  The parameters keep the
reference's layout — ``w`` is ``[in, out]`` and the forward is
``x @ w + b`` — so a flattened model lines up element for element with
the reference's (sorted keys: ``b`` before ``w``), and
``params_from_jax``/``params_to_numpy`` carry weights between the two
packages.  Random initialisation uses a ``torch.Generator``, so it does
not draw the reference's numbers; carry the weights over to start both
packages from the same point.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import dispatch

N_FEATURES = 121
N_CLASSES = 2
HIDDEN = 60


class SimpleNN(nn.Module):
    """Logistic regression 121 -> 2."""

    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        device = dispatch.resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter((torch.randn(N_FEATURES, N_CLASSES, generator=g)
                               / np.sqrt(N_FEATURES)).to(device))
        self.b = nn.Parameter(torch.zeros(N_CLASSES, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class ComplexNN(nn.Module):
    """MLP 121 -> 60 (ReLU) -> 2."""

    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        device = dispatch.resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.w1 = nn.Parameter((torch.randn(N_FEATURES, HIDDEN, generator=g)
                                / np.sqrt(N_FEATURES)).to(device))
        self.b1 = nn.Parameter(torch.zeros(HIDDEN, device=device))
        self.w2 = nn.Parameter((torch.randn(HIDDEN, N_CLASSES, generator=g)
                                / np.sqrt(HIDDEN)).to(device))
        self.b2 = nn.Parameter(torch.zeros(N_CLASSES, device=device))

    def forward(self, x):
        h = torch.relu(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


def make_model(kind: str, seed: int = 0, device="cuda") -> nn.Module:
    if kind == "simple":
        return SimpleNN(seed, device=device)
    if kind == "complex":
        return ComplexNN(seed, device=device)
    raise ValueError(kind)


def nll_loss(logits, labels):
    """Mean negative log-likelihood of integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def params_from_jax(tree, device="cuda") -> nn.Module:
    """A module holding the reference's parameters (a dict of arrays)."""
    kind = "simple" if set(tree) == {"w", "b"} else "complex"
    model = make_model(kind, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(np.array(tree[name], np.float32)))
    return model


def params_to_numpy(model) -> dict:
    """The module's parameters (or a parameter dict) as numpy arrays."""
    if isinstance(model, nn.Module):
        model = dict(model.named_parameters())
    return {k: v.detach().cpu().numpy() for k, v in model.items()}


def sgd_step(model: nn.Module, lr: float = 0.1):
    """``step(params, (x, y)) -> params``: one SGD step on ``nll_loss``
    of ``model``'s forward with ``params`` in place of its own."""
    device = next(model.parameters()).device

    def step(params, batch):
        x = torch.as_tensor(batch[0], dtype=torch.float32, device=device)
        y = torch.as_tensor(batch[1], device=device)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = nll_loss(torch.func.functional_call(model, p, (x,)), y)
        grads = torch.autograd.grad(loss, list(p.values()))
        return {k: (v - lr * g).detach()
                for (k, v), g in zip(p.items(), grads)}

    return step
