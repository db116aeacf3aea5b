"""Fault model: crashes, stragglers, elastic membership.

A copy of the numpy fault model of ``repro/fl/faults.py`` (the port
imports nothing of the reference): per-round crash/straggler draws from
``(seed, round_index)``, and one outcome brain (``resolve_outcome``)
that applies the committee quorum and the liveness floor, with the
blame sets of the malicious-secure round (tampering committee members,
poisoning dealers).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

#: Deterministic corruptions of a tampering committee member
#: (``committee_tamper=``): flip bits of its partial sum with this mask,
#: send a row of a polynomial keyed with the seed xor this constant, or
#: replay its round r-1 row.
TAMPER_FLIP_MASK = 0x00FF00FF
TAMPER_SEED_XOR = 0xBADBAD
TAMPER_MODES = ("flip", "wrong_poly", "replay")

#: Dealer adversary (``dealer_tamper=``): ``scale``/``sign_flip`` share
#: an update multiplied by +-POISON_SCALE (honest shares of a poisoned
#: value, caught by the norm audit); ``malformed`` corrupts its share
#: stream under honest commitments (caught by the per-dealer check, a
#: fatal protocol violation).  POISON_SCALE stays inside the codec's
#: clip, so the audit, not the clamp, catches the poison.
POISON_SCALE = 32.0
DEALER_TAMPER_MODES = ("scale", "sign_flip", "malformed")


def update_norm(decoded) -> float:
    """L2 norm of a decoded per-dealer update: float64 accumulation over
    the float32 decode, on the host, as the reference computes it, so
    the norm-bound blame decision is the reference's."""
    return float(np.linalg.norm(np.asarray(decoded, dtype=np.float64)))


@dataclasses.dataclass
class RoundOutcome:
    alive: set
    dropped: set
    straggled: set
    #: committee members caught tampering by the commitment check this
    #: round (evicted from later elections)
    blamed: set = dataclasses.field(default_factory=set)
    #: dealers whose updates broke the norm bound this round (left out of
    #: the mean, banned by the FedAvg driver)
    blamed_dealers: set = dataclasses.field(default_factory=set)


def round_rng(seed: int, round_index: int) -> np.random.RandomState:
    """Independent, reproducible per-round RNG from (seed, round)."""
    state = np.random.SeedSequence((int(seed) & 0xFFFFFFFF,
                                    int(round_index) & 0xFFFFFFFF))
    return np.random.RandomState(state.generate_state(1)[0])


def apply_faults(members: set, latency_s: dict[int, float],
                 deadline_s: float | None, *, seed: int = 0,
                 round_index: int = 0, crash_prob: float = 0.0,
                 committee: Sequence[int] | None = None,
                 reconstruct_threshold: int | None = None) -> RoundOutcome:
    """One round of crash/straggler faults over ``members``.

    ``committee``: the Phase-I committee, if any; ``reconstruct_threshold``
    the live members it needs (``degree + 1`` for Shamir, ``m`` for
    additive sharing).
    """
    rng = round_rng(seed, round_index)
    draws = {i: rng.rand() for i in sorted(members)}
    dropped = {i for i in members if draws[i] < crash_prob}
    straggled = set()
    if deadline_s is not None:
        straggled = {i for i in members - dropped
                     if latency_s.get(i, 0.0) > deadline_s}
    return resolve_outcome(members, dropped, straggled,
                           latency_s=latency_s, committee=committee,
                           reconstruct_threshold=reconstruct_threshold)


def resolve_outcome(members: set, dropped: set, straggled: set, *,
                    latency_s: dict[int, float] | None = None,
                    committee: Sequence[int] | None = None,
                    reconstruct_threshold: int | None = None,
                    resurrect: bool = True,
                    blamed: Iterable[int] = (),
                    blamed_dealers: Iterable[int] = ()) -> RoundOutcome:
    """Fold observed fault sets into a quorum-checked ``RoundOutcome``.

    ``resurrect``: whether faulted committee members may be brought back
    to reach the reconstruction threshold (the simulation's committee
    blocks until its quorum re-appears).  Blamed members and dealers are
    out of the round and never resurrected.
    """
    latency_s = latency_s or {}
    blamed = set(blamed) & set(members)
    blamed_dealers = set(blamed_dealers) & set(members) - blamed
    malicious = blamed | blamed_dealers
    dropped = set(dropped) & set(members) - malicious
    straggled = set(straggled) & set(members) - dropped - malicious
    alive = set(members) - dropped - straggled - malicious

    if committee is not None and reconstruct_threshold is not None:
        com = [w for w in committee if w not in malicious]
        alive, dropped, straggled = _enforce_committee_quorum(
            alive, dropped, straggled, set(members) - malicious,
            latency_s, com, reconstruct_threshold, resurrect=resurrect)

    if not alive:
        # quorum floor: never lose the round entirely; keep the fastest
        # non-blamed party
        pool = set(members) - malicious
        if not pool:
            raise ValueError(
                f"every member of {sorted(members)} was blamed — no "
                "honest party can carry the round")
        fastest = min(pool, key=lambda i: latency_s.get(i, 0.0))
        alive = {fastest}
        dropped.discard(fastest)
        straggled.discard(fastest)
    return RoundOutcome(alive=alive, dropped=dropped, straggled=straggled,
                        blamed=blamed, blamed_dealers=blamed_dealers)


def resolve_region_blames(accusations: dict, live_members) -> set:
    """Strict-majority quorum over tree-relay REGION_SUM accusations.

    Under ``relay="tree"`` every receiving member verifies each incoming
    REGION_SUM against the sender's regional Feldman commitments and
    accuses the *sender* (kind="region" BLAME) on a mismatch.  A member
    is condemned only when a strict majority of the *other* live members
    accuse it, so a single malicious receiver cannot frame an honest
    sender:

        |accusers ∩ (live − {accused})| · 2 > |live| − 1

    Self-accusations are discarded.
    """
    live = {int(w) for w in live_members}
    condemned = set()
    for accused, accusers in accusations.items():
        accused = int(accused)
        voters = {int(a) for a in accusers} & (live - {accused})
        if len(voters) * 2 > len(live) - 1:
            condemned.add(accused)
    return condemned


def _enforce_committee_quorum(alive, dropped, straggled, members,
                              latency_s, committee: Iterable[int],
                              threshold: int, resurrect: bool = True):
    """Resurrect faulted committee members until reconstruction works."""
    com_members = [w for w in committee if w in members]
    if len(com_members) < threshold:
        raise ValueError(
            f"committee {tuple(committee)} has only {len(com_members)} "
            f"members inside the live membership but reconstruction "
            f"needs {threshold}; re-elect before applying faults")
    live_com = [w for w in com_members if w in alive]
    if len(live_com) >= threshold:
        return alive, dropped, straggled
    if not resurrect:
        raise ValueError(
            f"only {len(live_com)} committee members alive but "
            f"reconstruction needs {threshold} shares, and faulted "
            f"members cannot be resurrected on this transport")
    candidates = sorted((w for w in com_members if w not in alive),
                        key=lambda i: latency_s.get(i, 0.0))
    for w in candidates:
        if len(live_com) >= threshold:
            break
        alive.add(w)
        dropped.discard(w)
        straggled.discard(w)
        live_com.append(w)
    return alive, dropped, straggled


def quorum_met(alive: set, n: int, quorum_frac: float = 0.5) -> bool:
    return len(alive) >= max(1, int(np.ceil(n * quorum_frac)))
