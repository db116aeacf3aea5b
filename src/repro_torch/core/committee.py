"""Phase I — MPC committee election (paper Alg. 2).

Counterpart of ``repro/core/committee.py``: every voter draws ``b``
Philox votes in ``[0, c)`` from stream ``(r << 20) | id``, the votes are
summed (wrap-around), reduced ``mod c`` and tallied, and the ``m``
highest tallies form the committee (lowest index wins ties).  The same
seed elects the same committee as the reference.

The ``c x b`` votes are drawn and summed on the given device (the card
unless the CPU is asked for); only the ``b`` summed words come back to
the host for the numpy tally, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from . import philox
from .field import U32_MASK


@dataclasses.dataclass(frozen=True)
class ElectionResult:
    committee: tuple[int, ...]   # party indices, sorted by score desc
    rounds: int                  # election rounds used
    tally: np.ndarray            # final per-party vote tally [n]


def draw_votes(n: int, b: int, key0, key1, round_index: int = 0):
    """Votes in ``[0, n)`` as ``int64`` ``[*B, b]`` (per key)."""
    bits = philox.random_bits(b, key0, key1,
                              counter_hi=0x5E1EC7 + round_index)
    return bits % n


def tally_votes(vote_sum, n: int) -> np.ndarray:
    """Aggregate vote vector -> per-party tally (Alg. 2 lines 22-25)."""
    idx = np.asarray(vote_sum, dtype=np.uint64) % np.uint64(n)
    return np.bincount(idx.astype(np.int64), minlength=n)


def select_committee(tally: np.ndarray, m: int, exclude=(),
                     reputation: dict[int, float] | None = None
                     ) -> list[int]:
    """Top-m parties by tally; deterministic lowest-index tie-break.

    ``exclude``: ids that may not serve (their votes still count).
    ``reputation``: optional per-party weight on the tally (float64
    score); ``None`` keeps the exact integer scoring.
    """
    excluded = set(int(i) for i in exclude)
    if reputation is None:
        order = np.lexsort((np.arange(len(tally)), -tally))
        voted = [int(i) for i in order
                 if tally[i] > 0 and i not in excluded]
        return voted[:m]
    weights = np.array([float(reputation.get(i, 1.0))
                        for i in range(len(tally))])
    score = tally.astype(np.float64) * weights
    order = np.lexsort((np.arange(len(tally)), -score))
    voted = [int(i) for i in order
             if tally[i] > 0 and score[i] > 0.0 and i not in excluded]
    return voted[:m]


def elect(n: int, m: int, b: int, seed: int, max_rounds: int = 8,
          exclude=(), reputation: dict[int, float] | None = None,
          device="cuda") -> ElectionResult:
    """The full election over parties ``0..n-1``."""
    return elect_among(range(n), m, b, seed, max_rounds=max_rounds,
                       exclude=exclude, reputation=reputation,
                       device=device)


def elect_among(ids, m: int, b: int, seed: int, max_rounds: int = 8,
                exclude=(), reputation: dict[int, float] | None = None,
                device="cuda") -> ElectionResult:
    """Alg. 2 over a voter set of global ids.

    Votes land in ``[0, c)`` with ``c = len(ids)`` and are tallied over
    positions in ``sorted(ids)``; winners map back to global ids.
    ``exclude``/``reputation`` are keyed by global id.  The votes are
    drawn on ``device``.
    """
    device = resolve_device(device)
    ids = sorted({int(i) for i in ids})
    c = len(ids)
    excluded = set(int(i) for i in exclude)
    if m > c:
        raise ValueError(f"committee m={m} larger than parties n={c}")
    if c - len(excluded & set(ids)) < m:
        raise ValueError(
            f"cannot elect a committee of {m} from {c} parties with "
            f"{sorted(excluded)} evicted")
    pos_exclude = [p for p, i in enumerate(ids) if i in excluded]
    pos_reputation = None
    if reputation is not None:
        pos_reputation = {p: float(reputation.get(i, 1.0))
                          for p, i in enumerate(ids)}
    tally = np.zeros(c, dtype=np.int64)
    streams = torch.tensor(ids, dtype=torch.int64).to(device)
    for r in range(max_rounds):
        # all voters' draws at once; the wrap-around sum is
        # order-independent, so this equals the per-party loop
        k0, k1 = philox.derive_key(seed, ((r << 20) | streams) & U32_MASK)
        votes = draw_votes(c, b, k0, k1, round_index=r)        # [c, b]
        total = votes.sum(dim=0) & U32_MASK
        tally = tally + tally_votes(total.cpu().numpy(), c)
        committee = select_committee(tally, m, exclude=pos_exclude,
                                     reputation=pos_reputation)
        if len(committee) == m:
            return ElectionResult(tuple(ids[p] for p in committee),
                                  r + 1, tally)
    raise RuntimeError(
        f"election failed to fill committee of {m} in {max_rounds} rounds "
        f"(n={c}, b={b}) — increase b")
