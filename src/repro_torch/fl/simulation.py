"""n-party simulation of the paper's protocols over one ``Network``.

Counterpart of ``repro/fl/simulation.py``: a thin shell holding one
counting transport per protocol, all sharing one ``Network``, so the
counters can be held against the closed forms of Eqs. 1–8
(``core.costmodel``; ``expected_costs``).  The malicious-security knobs
(``vss``, ``reelect_each_round``, ``norm_bound``, ``dealer_tamper``) and
``cohort`` go to the two-phase transport.  A ``repro_torch.api.
ExperimentSpec`` may stand in for the keyword arguments; an unknown
keyword raises ``TypeError`` with a did-you-mean hint.
``backend="wire"`` swaps the two-phase transport for the real
multi-process deployment (``repro_torch.net.WireTransport``, party
workers on the simulation's device); use it as a context manager (or
call ``close()``) so the worker processes are reaped.  Top-k
``compression`` runs in every simulated transport; on the wire it is
refused with the reference's ``ValueError``.
"""

from __future__ import annotations

import difflib
import inspect

from repro_torch.core import costmodel
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch

from .transport import (Network, P2PTransport, PhaseStats, PlainTransport,
                        Transport, TwoPhaseTransport, WIRE_TOPK_REFUSED,
                        check_kernel_backend)

__all__ = ["FLSimulation", "Network", "PhaseStats", "UnknownPartyError"]


class UnknownPartyError(ValueError):
    """``party_ids`` holds an id outside the registered ``range(n)``: its
    mask stream would be unmasked by nobody and its messages would be
    counted for a party the cost model does not know."""


class FLSimulation:
    """n-party simulation driving the transports over one Network, on
    ``device`` (the card unless ``"cpu"`` is asked for).

    ``kernel_backend`` must stay ``None`` (the device picks the path);
    ``wire_kwargs`` forwards extra ``WireTransport`` options
    (``log_dir=``, ``deadline_s=``, ...) under ``backend="wire"`` and is
    ignored by the simulation, as in the reference.
    """

    def __init__(self, n, m: int = 3, scheme: str = "additive",
                 seed: int = 0, b: int = 10,
                 fp: FixedPointConfig | None = None,
                 shamir_degree: int | None = None,
                 chunk: int = 2048, kernel_backend: str | None = None,
                 chunk_elems: int | None = None,
                 compression=None, backend: str = "sim",
                 wire_kwargs: dict | None = None,
                 vss: bool = False, reelect_each_round: bool = False,
                 norm_bound: float | None = None,
                 dealer_tamper: dict | None = None,
                 cohort: int | None = None, device="cuda", **unknown):
        if hasattr(n, "flsim_kwargs"):
            # an ExperimentSpec as the sole argument (and the device)
            self.__init__(**n.flsim_kwargs(), device=device)
            return
        if unknown:
            known = tuple(p for p in inspect.signature(
                FLSimulation.__init__).parameters
                if p not in ("self", "unknown"))
            hints = []
            for k in sorted(unknown):
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                         if close else ""))
            raise TypeError(
                f"FLSimulation got unknown aggregation kwargs: "
                f"{', '.join(hints)}; known kwargs are {known}")
        check_kernel_backend(kernel_backend)
        if backend not in ("sim", "wire"):
            raise ValueError(f"unknown backend {backend!r}; expected "
                             "'sim' or 'wire'")
        self.device = dispatch.resolve_device(device)
        self.n = n
        self.m = m
        self.b = b
        self.seed = seed
        self.scheme = scheme
        self.fp = fp
        self.backend = backend
        self.net = Network()
        self.round = 0
        kw = dict(m=m, b=b, scheme=scheme, seed=seed, net=self.net, fp=fp,
                  shamir_degree=shamir_degree, chunk=chunk,
                  chunk_elems=chunk_elems, compression=compression,
                  device=self.device)
        self.transports: dict[str, Transport] = {
            "plain": PlainTransport(n, **kw),
            "p2p": P2PTransport(n, **kw),
        }
        # the malicious-security knobs are two-phase only: commitments
        # verify committee partial sums, and per-round re-election is the
        # committee's Phase I
        two_phase = dict(vss=vss, reelect_each_round=reelect_each_round,
                         norm_bound=norm_bound, dealer_tamper=dealer_tamper,
                         cohort=cohort)
        if backend == "wire":
            # the real multi-process deployment of the paper's protocol;
            # the baselines stay in-sim (the wire only speaks two_phase)
            if compression is not None:
                # the wire has no top-k; the sim transport's refusals
                # (VSS with top-k, ...) come first, as in the reference
                TwoPhaseTransport(n, **two_phase, **kw)
                raise ValueError(WIRE_TOPK_REFUSED)
            from repro_torch.net import WireTransport
            self.transports["two_phase"] = WireTransport(
                n, m=m, b=b, scheme=scheme, seed=seed, net=self.net,
                fp=fp, shamir_degree=shamir_degree,
                chunk_elems=chunk_elems, device=self.device, **two_phase,
                **(wire_kwargs or {}))
        else:
            self.transports["two_phase"] = TwoPhaseTransport(
                n, **two_phase, **kw)

    @property
    def committee(self):
        return self.transports["two_phase"].committee

    # -- Phase I ----------------------------------------------------------

    def elect_committee(self, eligible=None) -> tuple[int, ...]:
        """Alg. 2 with counted messages (P2P MPC on b-vectors).

        ``eligible`` (cohort mode) restricts the sampling pool to the
        current membership (``run_fedavg``'s); ignored otherwise.
        """
        return self.transports["two_phase"].elect(self.round,
                                                  eligible=eligible)

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
        bad = sorted(i for i in {int(i) for i in party_ids}
                     if not 0 <= i < self.n)
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
        # the fault injections are simulated; on the wire members drop
        # or tamper by doing it, so the keywords go through only when
        # set (a TypeError there rather than an ignored fault)
        kw = ({"committee_dropout": committee_dropout}
              if committee_dropout else {})
        if committee_tamper:
            kw["committee_tamper"] = committee_tamper
        mean = self.transports["two_phase"].aggregate(
            [flats[i] for i in live], party_ids=live,
            round_index=self.round, **kw)
        self.round += 1
        return mean, self.net.stats()

    # -- lifecycle (the wire backend owns OS processes) ---------------------

    def close(self) -> None:
        for tr in self.transports.values():
            closer = getattr(tr, "close", None)
            if closer is not None:
                closer()

    def __enter__(self) -> "FLSimulation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- paper-equation cross-check -----------------------------------------

    def expected_costs(self, s: int, e: int,
                       cohort: int | None = None) -> dict:
        """The closed forms at this simulation's n, m, b (per cohort of
        ``cohort`` when given)."""
        p = costmodel.CostParams(n=self.n, e=e, s=s, m=self.m, b=self.b)
        if cohort is not None:
            return costmodel.summary_cohort(p, cohort)
        return costmodel.summary(p)

    def phase2_stats(self) -> PhaseStats:
        tot = PhaseStats()
        for name in ("phase2_upload", "phase2_exchange", "phase2_broadcast"):
            st = self.net.stats(name)
            tot.msg_num += st.msg_num
            tot.msg_size += st.msg_size
        return tot
