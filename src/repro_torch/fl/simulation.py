"""n-party simulation of the paper's protocols over one ``Network``.

Counterpart of ``repro/fl/simulation.py``: a thin shell holding one
counting transport per protocol, all sharing one ``Network``, so the
counters can be held against the closed forms of Eqs. 1–8
(``core.costmodel``).  The malicious-security knobs (``vss``,
``reelect_each_round``, ``norm_bound``, ``dealer_tamper``) go to the
two-phase transport; the wire backend and cohorts belong to later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

from .transport import (Network, P2PTransport, PhaseStats, PlainTransport,
                        Transport, TwoPhaseTransport, reject_later)

__all__ = ["FLSimulation", "Network", "PhaseStats", "UnknownPartyError"]


class UnknownPartyError(ValueError):
    """``party_ids`` holds an id outside the registered ``range(n)``: its
    mask stream would be unmasked by nobody and its messages would be
    counted for a party the cost model does not know."""


class FLSimulation:
    """n-party simulation driving the transports over one Network, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, n: int, m: int = 3, scheme: str = "additive",
                 seed: int = 0, b: int = 10,
                 fp: FixedPointConfig | None = None,
                 shamir_degree: int | None = None,
                 chunk: int = 2048, chunk_elems: int | None = None,
                 device="cuda", compression=None, backend: str = "sim",
                 vss: bool = False, reelect_each_round: bool = False,
                 norm_bound: float | None = None,
                 dealer_tamper: dict | None = None,
                 cohort: int | None = None):
        reject_later(compression=compression, backend=backend,
                     cohort=cohort)
        self.device = dispatch.resolve_device(device)
        self.n = n
        self.m = m
        self.b = b
        self.seed = seed
        self.scheme = scheme
        self.fp = fp
        self.net = Network()
        self.round = 0
        kw = dict(m=m, b=b, scheme=scheme, seed=seed, net=self.net, fp=fp,
                  shamir_degree=shamir_degree, chunk=chunk,
                  chunk_elems=chunk_elems, device=self.device)
        self.transports: dict[str, Transport] = {
            "plain": PlainTransport(n, **kw),
            "p2p": P2PTransport(n, **kw),
            # the malicious-security knobs are two-phase only:
            # commitments verify committee partial sums, and per-round
            # re-election is the committee's Phase I
            "two_phase": TwoPhaseTransport(
                n, vss=vss, reelect_each_round=reelect_each_round,
                norm_bound=norm_bound, dealer_tamper=dealer_tamper, **kw),
        }

    @property
    def committee(self):
        return self.transports["two_phase"].committee

    # -- Phase I ----------------------------------------------------------

    def elect_committee(self) -> tuple[int, ...]:
        """Alg. 2 with counted messages (P2P MPC on b-vectors)."""
        return self.transports["two_phase"].elect(self.round)

    # -- protocol dispatch -------------------------------------------------

    def aggregate(self, protocol: str, flats, party_ids=None, **kw):
        """One aggregation round over the named transport; returns
        ``(mean, total network stats)``."""
        if party_ids is not None:
            self._check_party_ids(party_ids)
        mean = self.transports[protocol].aggregate(
            flats, party_ids, round_index=self.round, **kw)
        self.round += 1
        return mean, self.net.stats()

    def _check_party_ids(self, party_ids) -> None:
        bad = sorted({int(i) for i in party_ids} - set(range(self.n)))
        if bad:
            raise UnknownPartyError(
                f"party_ids contains ids not registered with this "
                f"FLSimulation(n={self.n}): {bad}; valid ids are "
                f"0..{self.n - 1}")

    def aggregate_two_phase(self, flats: list,
                            alive: set[int] | None = None,
                            committee_dropout=(),
                            committee_tamper: dict | None = None):
        """Alg. 3: share upload -> committee chain-sum -> broadcast, with
        injected member dropouts and (``vss=True``) member tampering."""
        live = sorted(alive) if alive is not None else list(range(self.n))
        mean = self.transports["two_phase"].aggregate(
            [flats[i] for i in live], party_ids=live,
            round_index=self.round, committee_dropout=committee_dropout,
            committee_tamper=committee_tamper)
        self.round += 1
        return mean, self.net.stats()

    def phase2_stats(self) -> PhaseStats:
        tot = PhaseStats()
        for name in ("phase2_upload", "phase2_exchange", "phase2_broadcast"):
            st = self.net.stats(name)
            tot.msg_num += st.msg_num
            tot.msg_size += st.msg_size
        return tot
