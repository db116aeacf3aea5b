"""LR schedules: warmup + cosine / inverse-sqrt.

Counterpart of ``repro/optim/schedule.py``: the same float32 sequence,
on a float32 0-d tensor (``step`` a host int or a tensor).
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def inverse_sqrt(step, *, peak_lr: float, warmup: int):
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    decay = peak_lr * torch.sqrt(warmup / torch.clamp(step, min=warmup))
    return torch.where(step < warmup, warm, decay)
