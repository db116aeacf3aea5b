"""Transport layer — who sends what to whom, per phase, in the simulation.

Counterpart of the counting transports of ``repro/fl/transport.py``:

* ``PlainTransport``    — un-encrypted FedAvg, l·(l−1) messages of s;
* ``P2PTransport``      — Alg. 1, 2·l·(l−1) messages of s (Eqs. 1–2);
* ``TwoPhaseTransport`` — Phase I election (Alg. 2, 2·n·(n−1) messages
  of b per election round, Eqs. 3–4) and Phase II (Alg. 3: l·m uploads,
  m−1 chain exchanges, n broadcasts, Eqs. 5–6), with party dropouts and
  Shamir committee dropouts.

The party-side math runs through ``SecureAggregator`` on the
transport's device.  Knobs of later slices of the port raise
``NotImplementedError`` naming the slice (``reject_later``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Sequence

import torch

from repro_torch.core import committee as committee_mod
from repro_torch.core.aggregation import SecureAggregator, _check_chunk_elems
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

__all__ = ["Network", "P2PTransport", "PhaseStats", "PlainTransport",
           "Transport", "TwoPhaseTransport", "make_transport",
           "reject_later"]

#: Knobs of the reference that later slices of the port carry over
#: (ROADMAP.md, queue 1), and the slice each belongs to.
LATER_SLICES = {
    "vss": "malicious security (queue 1, item 7)",
    "norm_bound": "malicious security (queue 1, item 7)",
    "dealer_tamper": "malicious security (queue 1, item 7)",
    "committee_tamper": "malicious security (queue 1, item 7)",
    "reelect_each_round": "malicious security (queue 1, item 7)",
    "cohort": "cohorts, with malicious security (queue 1, item 7)",
    "eligible": "cohorts, with malicious security (queue 1, item 7)",
    "compression": "top-k compression (queue 1, item 5)",
    "compress_topk": "top-k compression (queue 1, item 5)",
    "backend": "the wire transport (queue 1, item 8) and SPMD "
               "(queue 1, item 9)",
    "agg_kwargs": "the typed experiment API (queue 1, item 7)",
}


def reject_later(**knobs) -> None:
    """Raise ``NotImplementedError`` for a later-slice knob that is set.

    A knob at its default (``None``, ``False``, empty, or
    ``backend="sim"``) passes.
    """
    for name, value in knobs.items():
        if name == "backend" and value == "sim":
            continue
        if value is None or value is False or (
                isinstance(value, (dict, tuple, list, set))
                and not value):
            continue
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet: it belongs to "
            f"{LATER_SLICES[name]} of the PyTorch port")


# ---------------------------------------------------------------------------
# Message-counting network
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseStats:
    msg_num: int = 0
    msg_size: int = 0          # in elements, paper convention

    def add_batch(self, count: int, size: int):
        """Count ``count`` messages of ``size`` elements each."""
        if count < 0:
            raise ValueError(
                f"message count must be non-negative, got {count}")
        if size <= 0:
            raise ValueError(
                f"message size must be positive, got {size}")
        self.msg_num += count
        self.msg_size += count * size


class Network:
    """Counts every point-to-point message, per phase."""

    def __init__(self):
        self.phases: dict[str, PhaseStats] = {}

    def send_batch(self, count: int, n_elems: int, phase: str):
        """``count`` messages of ``n_elems`` each, in one call."""
        self.phases.setdefault(phase, PhaseStats()).add_batch(count, n_elems)

    def stats(self, phase: str | None = None) -> PhaseStats:
        if phase is not None:
            return self.phases.get(phase, PhaseStats())
        total = PhaseStats()
        for p in self.phases.values():
            total.msg_num += p.msg_num
            total.msg_size += p.msg_size
        return total


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class Transport(abc.ABC):
    """One aggregation protocol: wire behaviour + party-side dataflow."""

    protocol: str

    def elect(self, round_index: int = 0):
        """Run Phase I if the protocol has one; returns the committee."""
        return None

    @abc.abstractmethod
    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        """Aggregate the live parties' flat updates ``[l, D]`` into their
        mean.  ``party_ids`` are the original ids of the rows (party
        ``i`` always masks with its own stream); default ``0..l-1``."""


class _SimTransport(Transport):
    """Shared state of the counting transports.

    ``chunk``: party-chunk size of the share engine; ``chunk_elems``:
    element-chunk size of the streaming path (``None`` keeps the
    whole vector; the bits are the same either way).
    """

    def __init__(self, n: int, *, m: int = 3, scheme: str = "additive",
                 seed: int = 0, b: int = 10, net: Network | None = None,
                 fp: FixedPointConfig | None = None,
                 shamir_degree: int | None = None, chunk: int = 2048,
                 chunk_elems: int | None = None, device="cuda",
                 compression=None):
        reject_later(compression=compression)
        self.n = n
        self.m = m
        self.b = b
        self.seed = seed
        self.scheme = scheme
        self.fp = fp
        self.shamir_degree = shamir_degree
        self.chunk = chunk
        self.chunk_elems = (None if chunk_elems is None
                            else _check_chunk_elems(chunk_elems))
        self.device = dispatch.resolve_device(device)
        self.net = net if net is not None else Network()

    def _as_batch(self, flats) -> torch.Tensor:
        if isinstance(flats, (list, tuple)):
            flats = torch.stack([torch.as_tensor(f) for f in flats])
        return torch.as_tensor(flats, dtype=torch.float32).to(
            self.device).contiguous()

    @staticmethod
    def _ids(party_ids, l: int) -> list[int]:
        if party_ids is None:
            return list(range(l))
        ids = [int(i) for i in party_ids]
        if len(ids) != l:
            raise ValueError(f"{l} updates but {len(ids)} party ids")
        return ids

    def _aggregator(self, m: int) -> SecureAggregator:
        return SecureAggregator(scheme=self.scheme, m=m, fp=self.fp,
                                shamir_degree=self.shamir_degree,
                                device=self.device)

    def _secure_mean(self, agg: SecureAggregator, flats, ids, round_index,
                     member_rows=None, points=None):
        """Party-side share math through ``agg``; the l-party mean."""
        l = int(flats.shape[0])
        if self.chunk_elems is not None:
            return agg.aggregate_stream(
                flats, seed=self.seed, party_ids=ids,
                round_index=round_index, chunk_elems=self.chunk_elems,
                party_chunk=self.chunk, member_rows=member_rows,
                points=points)
        member_sums = agg.sum_shares_batch(
            flats, seed=self.seed, party_ids=ids,
            round_index=round_index, chunk=self.chunk)
        if member_rows is not None:
            member_sums = member_sums[list(member_rows)]
        return agg.reconstruct_mean(member_sums, l, points=points)


class PlainTransport(_SimTransport):
    """Un-encrypted FedAvg exchange (the paper's "withoutMPC" curve)."""

    protocol = "plain"

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        flats = self._as_batch(flats)
        l, s = int(flats.shape[0]), int(flats.shape[1])
        self._ids(party_ids, l)
        # every live party sends its update to every other live party
        self.net.send_batch(l * (l - 1), s, "plain")
        return flats.mean(dim=0)


class P2PTransport(_SimTransport):
    """Alg. 1 on the whole flattened model: l−1 share messages and l−1
    partial-sum messages per party ⇒ 2·l·(l−1) messages of size s."""

    protocol = "p2p"

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        flats = self._as_batch(flats)
        l, s = int(flats.shape[0]), int(flats.shape[1])
        ids = self._ids(party_ids, l)
        agg = self._aggregator(l)
        agg.fp.validate_for_parties(l)
        self.net.send_batch(l * (l - 1), s, "p2p")  # shares V(i, j)
        self.net.send_batch(l * (l - 1), s, "p2p")  # partial sums S(i)
        return self._secure_mean(agg, flats, ids, round_index)


class TwoPhaseTransport(_SimTransport):
    """The paper's two-phase protocol (Algs. 2 + 3).

    Phase I: committee election as a P2P additive MPC on b-vectors.
    Phase II: share upload (l·m) → committee chain partial-sum exchange
    (m−1) → broadcast (n) ⇒ (l·m + m − 1 + n) messages of size s.
    Committee-member dropouts (``committee_dropout``) are tolerated by
    the Shamir scheme while the live members hold ``degree + 1``
    evaluation points (sub-threshold reconstruction).
    """

    protocol = "two_phase"

    def __init__(self, n: int, *, vss: bool = False,
                 reelect_each_round: bool = False,
                 norm_bound: float | None = None,
                 dealer_tamper: dict | None = None,
                 cohort: int | None = None, **kw):
        reject_later(vss=vss, reelect_each_round=reelect_each_round,
                     norm_bound=norm_bound, dealer_tamper=dealer_tamper,
                     cohort=cohort)
        super().__init__(n, **kw)
        self.committee: tuple[int, ...] | None = None
        self.agg = self._aggregator(self.m)

    @property
    def degree(self) -> int:
        return (self.agg.shamir_degree
                if self.agg.shamir_degree is not None else self.m - 1)

    # -- Phase I ----------------------------------------------------------

    def elect(self, round_index: int = 0) -> tuple[int, ...]:
        """Alg. 2 with counted messages (P2P MPC on b-vectors)."""
        result = committee_mod.elect(self.n, self.m, self.b,
                                     self.seed + round_index,
                                     device=self.device)
        # each election round is one P2P additive MPC exchange of
        # b-element messages (shares + partial sums)
        self.net.send_batch(result.rounds * 2 * self.n * (self.n - 1),
                            self.b, "phase1")
        self.committee = result.committee
        return result.committee

    # -- Phase II ---------------------------------------------------------

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0,
                  committee_dropout: Sequence[int] = (),
                  committee_tamper: dict | None = None, eligible=None):
        reject_later(committee_tamper=committee_tamper, eligible=eligible)
        if self.committee is None:
            self.elect(round_index)
        flats = self._as_batch(flats)
        l, s = int(flats.shape[0]), int(flats.shape[1])
        ids = self._ids(party_ids, l)
        # the committee sums l encodings — same headroom bound as P2P
        self.agg.fp.validate_for_parties(l)
        dropped = set(int(i) for i in committee_dropout)
        live_pos = [w for w, member in enumerate(self.committee)
                    if member not in dropped]
        m_live = len(live_pos)
        # validate before touching the counters
        if m_live < self.m:
            if self.scheme != "shamir":
                raise ValueError(
                    "additive sharing cannot reconstruct with committee "
                    f"members {sorted(dropped)} down — use scheme='shamir' "
                    "with degree < m-1 for committee fault tolerance")
            if m_live < self.degree + 1:
                raise ValueError(
                    f"only {m_live} committee members alive but Shamir "
                    f"degree {self.degree} needs {self.degree + 1} shares")

        # 1) every live party uploads one share to each live member
        self.net.send_batch(l * m_live, s, "phase2_upload")
        # 2) members chain-exchange partial sums (m−1, Eq. 5 middle term)
        self.net.send_batch(m_live - 1, s, "phase2_exchange")
        # 3) the committee broadcasts the aggregate to every party
        self.net.send_batch(self.n, s, "phase2_broadcast")

        if m_live == self.m:
            return self._secure_mean(self.agg, flats, ids, round_index)
        points = tuple(w + 1 for w in live_pos)
        return self._secure_mean(self.agg, flats, ids, round_index,
                                 member_rows=live_pos, points=points)


SIM_TRANSPORTS = {
    "plain": PlainTransport,
    "p2p": P2PTransport,
    "two_phase": TwoPhaseTransport,
}


def make_transport(protocol: str, n: int, *, backend: str = "sim",
                   device="cuda", **kw) -> Transport:
    """Factory of the counting simulation transports on ``device``."""
    reject_later(backend=backend)
    if protocol not in SIM_TRANSPORTS:
        raise ValueError(
            f"unknown protocol {protocol!r}; expected one of "
            f"{sorted(SIM_TRANSPORTS)}")
    return SIM_TRANSPORTS[protocol](n, device=device, **kw)
