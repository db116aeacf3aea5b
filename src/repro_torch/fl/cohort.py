"""Seeded per-round cohort sampling over a large party registry.

Counterpart of ``repro/fl/cohort.py`` (DESIGN.md §12): each round runs
over a *cohort* of ``c`` parties drawn from a registry of ``n``.  The
draw is keyed per party id: party ``i``'s rank for round ``r`` is word
``i`` of the Philox stream ``derive_key(seed, COHORT_STREAM)`` at
``counter_hi = COHORT_COUNTER_HI + r``, and the ``c`` lowest ranks (ties
broken by id) form the cohort.  Churn in the rest of the pool never
changes whether party ``i`` ranks in, so the per-cohort closed forms
stay exact under registry churn.

The words are drawn and ranked on the given device (the card unless the
CPU is asked for): one selection of the ``c`` smallest int64 keys
``bits << 31 | id``, which order as the reference's ``(bits[i], i)`` for
ids below 2^31.  The
result is a tuple of Python ints, equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import philox
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["CohortConfig", "CohortExhaustedError", "assign_home",
           "sample_cohort", "COHORT_STREAM", "COHORT_COUNTER_HI",
           "HOME_STREAM", "HOME_COUNTER_HI"]

#: Philox stream id of the cohort schedule (a ``derive_key`` stream of
#: its own, unrelated to the election streams ``(r << 20) | id``)
COHORT_STREAM = 0xC0_4057
#: counter_hi tag; the per-round offset rides on top of it
COHORT_COUNTER_HI = 0x11_0000
#: Philox stream id of the home-member assignment (the wire's relay
#: tree, DESIGN.md §13)
HOME_STREAM = 0x40_73EE
#: counter_hi tag of the home-member draw; per-round offset on top
HOME_COUNTER_HI = 0x12_0000
#: ids must fit the low 31 bits of the sort key
_ID_LIMIT = 1 << 31


class CohortExhaustedError(RuntimeError):
    """No eligible party remains to sample a cohort from (every
    registered party banned, evicted or expired).  A round cannot run
    without a cohort, so the transports let it propagate."""


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Per-round cohort sampling parameters.

    ``size`` — target cohort size ``c``; when fewer than ``c`` parties
    are eligible the cohort shrinks to the whole eligible set (an empty
    eligible set raises :class:`CohortExhaustedError`).
    """
    size: int

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"cohort size={self.size} must be >= 1")


def _sorted_ids(ids_in, what: str) -> list[int]:
    ids = sorted({int(i) for i in ids_in})
    if ids and ids[0] < 0:
        raise ValueError(f"negative party id in {what}: {ids[0]}")
    if ids and ids[-1] >= _ID_LIMIT:
        raise ValueError(f"party id {ids[-1]} in {what} is not below 2^31")
    return ids


def sample_cohort(eligible_ids, size: int, seed: int, round_index: int,
                  device="cuda") -> tuple[int, ...]:
    """The round's cohort: ``size`` eligible ids, sorted.

    Deterministic in ``(seed, round_index, eligible set)`` and stable per
    id under churn of the rest of the pool.
    """
    device = resolve_device(device)
    ids = _sorted_ids(eligible_ids, "eligible set")
    if not ids:
        raise CohortExhaustedError(
            f"round {round_index}: no eligible parties to sample a "
            f"cohort of {size} from (all registered parties banned, "
            f"evicted, or expired)")
    if len(ids) <= size:
        return tuple(ids)
    idx = torch.tensor(ids, dtype=torch.int64).to(device)
    bits = _stream_words(seed, COHORT_STREAM,
                         COHORT_COUNTER_HI + round_index, ids[-1] + 1,
                         device)[idx]
    # one int64 key orders as (bits[i], i): bits < 2^32, ids < 2^31;
    # the keys are distinct, so the ``size`` smallest are the cohort
    lowest = torch.topk((bits << 31) | idx, size, largest=False,
                        sorted=False).values
    return tuple(sorted((lowest & (_ID_LIMIT - 1)).tolist()))


def assign_home(party_ids, committee, seed: int, round_index: int,
                device="cuda") -> dict[int, int]:
    """Each party's *home* committee member for the tree relay: party
    ``i``'s home for round ``r`` is ``sorted(committee)[bits[i] % m]``
    with ``bits`` from the ``HOME_STREAM`` stream at ``counter_hi =
    HOME_COUNTER_HI + r``, so churn in the rest of the cohort never moves
    a surviving party's home."""
    device = resolve_device(device)
    ids = _sorted_ids(party_ids, "cohort")
    members = sorted({int(w) for w in committee})
    if not members:
        raise ValueError("assign_home needs a non-empty committee")
    if not ids:
        return {}
    idx = torch.tensor(ids, dtype=torch.int64).to(device)
    bits = _stream_words(seed, HOME_STREAM, HOME_COUNTER_HI + round_index,
                         ids[-1] + 1, device)[idx]
    slots = (bits % len(members)).tolist()
    return {i: members[k] for i, k in zip(ids, slots)}


def _stream_words(seed: int, stream: int, counter_hi: int, count: int,
                  device) -> torch.Tensor:
    """The first ``count`` words of stream ``derive_key(seed, stream)``
    at ``counter_hi``, as ``int64`` on ``device``."""
    k0, k1 = philox.derive_key(seed, stream)
    return philox.random_bits(count, k0, k1, counter_hi=counter_hi,
                              device=device)
