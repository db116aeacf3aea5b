"""``repro_torch.api`` — the one typed entry point for experiments.

Counterpart of ``repro/api.py``.  One frozen :class:`ExperimentSpec`
names everything an experiment is: aggregation scheme, fixed-point
codec, compression, malicious security (VSS and the norm audit),
per-round cohort sampling, backend, and optionally a named adversarial
scenario.  Every entry point of the port accepts it:

    from repro_torch.api import ExperimentSpec, make_transport

    spec = ExperimentSpec(n=100, m=3, scheme="shamir", vss=True,
                          cohort=10)
    result = run_fedavg(spec, init_params, step_fn, batches)   # FedAvg
    sim = FLSimulation(spec)                                   # harness
    record = run_scenario(spec_with_scenario)                  # battery
    tr = make_transport(spec)                                  # factory

Each takes ``device=`` (the card unless ``"cpu"`` is asked for).  The
spec has the reference's fields, in its order and with its defaults, so
a JSON file written by either package loads in the other
(:meth:`to_json` / :meth:`from_json`, which rejects unknown keys with a
did-you-mean hint).  ``backend="wire"`` deploys the spec over party
worker processes (``repro_torch.net``); ``compress_topk`` runs in the
simulation and is refused on the wire with the reference's
``FLSimulation`` ``ValueError`` (by ``make_transport`` too, before a port
is bound).
``kernel_backend`` stays a field for that compatibility; the port
dispatches by device, so any value but ``None`` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import difflib

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.fl.transport import (WIRE_TOPK_REFUSED,
                                      check_kernel_backend)

__all__ = ["ExperimentSpec", "make_transport"]

_PROTOCOLS = ("two_phase", "p2p", "plain")


def _reject_unknown(cls, obj: dict, what: str) -> None:
    """Reject unknown keys with a did-you-mean hint."""
    known = tuple(f.name for f in dataclasses.fields(cls))
    unknown = sorted(set(obj) - set(known))
    if not unknown:
        return
    hints = []
    for k in unknown:
        close = difflib.get_close_matches(k, known, n=1)
        hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                 if close else ""))
    raise ValueError(
        f"{what} carries unknown keys: {', '.join(hints)}; known keys "
        f"are {known}")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything one experiment is, in one frozen value."""

    # -- federation shape -------------------------------------------------
    n: int
    m: int = 3
    epochs: int = 15
    local_steps: int = 3
    protocol: str = "two_phase"    # two_phase | p2p | plain
    scheme: str = "additive"       # additive | shamir
    vote_batch: int = 10
    seed: int = 0
    #: FedAvg round deadline (straggler resolution; None = off)
    deadline_s: float | None = None
    # -- fixed-point codec (None = the scheme's default codec) ------------
    frac_bits: int | None = None
    clip: float | None = None
    # -- compression ------------------------------------------------------
    compress_topk: float | None = None
    error_feedback: bool = True
    chunk_elems: int | None = None
    # -- malicious security (DESIGN.md §10-11) ----------------------------
    vss: bool = False
    shamir_degree: int | None = None
    norm_bound: float | None = None
    reelect_each_round: bool = False
    #: injected dealer adversary {party: (mode, round)}
    dealer_tamper: dict | None = None
    # -- cohort sampling and the wire's lease fields (DESIGN.md §12) ------
    cohort: int | None = None
    pipeline: bool = False
    lease_s: float | None = 30.0
    #: wire relay topology, "hub" or "tree" (the simulation's counters do
    #: not depend on it)
    relay: str = "hub"
    # -- backend ----------------------------------------------------------
    backend: str = "sim"           # sim | wire
    #: must stay None in the port (the device picks the path)
    kernel_backend: str | None = None
    #: extra options of the wire backend
    wire_kwargs: dict | None = None
    # -- adversarial scenario (fl.scenarios) ------------------------------
    scenario: object | None = None

    def __post_init__(self):
        if self.protocol not in _PROTOCOLS:
            raise ValueError(f"protocol {self.protocol!r} not one of "
                             f"{_PROTOCOLS}")
        if self.backend not in ("sim", "wire"):
            raise ValueError(f"backend {self.backend!r} not sim|wire")
        if self.scheme not in ("additive", "shamir"):
            raise ValueError(f"scheme {self.scheme!r} not "
                             "additive|shamir")
        if self.cohort is not None and not 1 <= self.cohort <= self.n:
            raise ValueError(f"cohort={self.cohort} must be in "
                             f"1..n={self.n}")
        if self.pipeline and self.cohort is None:
            raise ValueError("pipeline=True needs cohort mode (only "
                             "per-round cohort elections can overlap "
                             "the previous round's Phase II)")
        if self.relay not in ("hub", "tree"):
            raise ValueError(f"relay={self.relay!r} must be 'hub' or "
                             "'tree'")
        if (self.frac_bits is None) != (self.clip is None):
            raise ValueError("frac_bits and clip come as a pair (both "
                             "set = custom codec, both None = the "
                             "scheme's default)")
        check_kernel_backend(self.kernel_backend)

    # -- per-layer conversions --------------------------------------------

    def fp(self) -> FixedPointConfig | None:
        """Custom fixed-point codec, or None for the scheme default."""
        if self.frac_bits is None:
            return None
        return FixedPointConfig(
            frac_bits=self.frac_bits, clip=self.clip,
            algebra="field" if self.scheme == "shamir" else "ring")

    def compression(self) -> CompressionConfig | None:
        if not self.compress_topk:
            return None
        return CompressionConfig(enabled=True,
                                 top_k_ratio=self.compress_topk,
                                 error_feedback=self.error_feedback)

    def _wire_kwargs(self) -> dict | None:
        """The wire's extra options with the spec's lease fields folded
        in (explicit ``wire_kwargs`` entries win)."""
        if self.backend != "wire":
            return self.wire_kwargs
        return {"pipeline": self.pipeline, "lease_s": self.lease_s,
                "relay": self.relay, **(self.wire_kwargs or {})}

    def fedavg_config(self):
        """The ``fl.rounds.FedAvgConfig`` this spec describes
        (``run_fedavg`` calls this itself when handed a spec)."""
        from repro_torch.fl.rounds import FedAvgConfig
        return FedAvgConfig(
            n_parties=self.n, epochs=self.epochs,
            local_steps=self.local_steps, committee=self.m,
            scheme=self.scheme, protocol=self.protocol,
            vote_batch=self.vote_batch, seed=self.seed,
            deadline_s=self.deadline_s,
            compress_topk=self.compress_topk,
            error_feedback=self.error_feedback,
            chunk_elems=self.chunk_elems, backend=self.backend,
            vss=self.vss, shamir_degree=self.shamir_degree,
            fp=self.fp(), kernel_backend=self.kernel_backend,
            norm_bound=self.norm_bound,
            dealer_tamper=self.dealer_tamper,
            reelect_each_round=self.reelect_each_round,
            wire_kwargs=self._wire_kwargs(), cohort=self.cohort)

    def flsim_kwargs(self) -> dict:
        """Keyword arguments of ``fl.simulation.FLSimulation`` (whose
        ``__init__`` calls this when handed a spec)."""
        return dict(
            n=self.n, m=self.m, scheme=self.scheme, seed=self.seed,
            b=self.vote_batch, fp=self.fp(),
            shamir_degree=self.shamir_degree,
            kernel_backend=self.kernel_backend,
            chunk_elems=self.chunk_elems,
            compression=self.compression(), backend=self.backend,
            wire_kwargs=self._wire_kwargs(), vss=self.vss,
            reelect_each_round=self.reelect_each_round,
            norm_bound=self.norm_bound,
            dealer_tamper=self.dealer_tamper, cohort=self.cohort)

    def wire_config(self):
        """The ``net.config.WireConfig`` a WELCOME frame would carry."""
        from repro_torch.net.config import WireConfig
        return WireConfig.from_aggregation_kwargs(
            self.n, m=self.m, b=self.vote_batch, seed=self.seed,
            scheme=self.scheme, fp=self.fp(),
            shamir_degree=self.shamir_degree,
            chunk_elems=self.chunk_elems, vss=self.vss,
            reelect_each_round=self.reelect_each_round,
            norm_bound=self.norm_bound, cohort=self.cohort,
            pipeline=self.pipeline, lease_s=self.lease_s,
            relay=self.relay)

    def wire_transport_kwargs(self) -> dict:
        """Keyword arguments of ``repro_torch.net.WireTransport`` (the
        device apart; ``launch.serve_fl`` deploys a spec with them)."""
        return dict(
            n=self.n, m=self.m, scheme=self.scheme, seed=self.seed,
            b=self.vote_batch, fp=self.fp(),
            shamir_degree=self.shamir_degree,
            chunk_elems=self.chunk_elems, vss=self.vss,
            reelect_each_round=self.reelect_each_round,
            norm_bound=self.norm_bound, cohort=self.cohort,
            pipeline=self.pipeline, lease_s=self.lease_s,
            relay=self.relay, dealer_tamper=self.dealer_tamper,
            **(self.wire_kwargs or {}))

    def scenario_config(self):
        """The spec's scenario with the shared fields (n, m, scheme,
        seed, backend, cohort, ...) overridden by the spec
        (``run_scenario`` calls this itself when handed a spec)."""
        if self.scenario is None:
            raise ValueError(
                "this ExperimentSpec has no scenario= — set one (an "
                "fl.scenarios.ScenarioConfig) to run it through "
                "run_scenario")
        return dataclasses.replace(
            self.scenario, n=self.n, m=self.m, epochs=self.epochs,
            local_steps=self.local_steps, seed=self.seed,
            scheme=self.scheme, shamir_degree=self.shamir_degree,
            vss=self.vss, vote_batch=self.vote_batch,
            norm_bound=self.norm_bound, cohort=self.cohort,
            backend=self.backend, wire_kwargs=self._wire_kwargs())

    def simulation(self, device="cuda"):
        """A ready ``FLSimulation`` over this spec on ``device``."""
        from repro_torch.fl.simulation import FLSimulation
        return FLSimulation(self, device=device)

    # -- JSON round-trip ---------------------------------------------------

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "ExperimentSpec":
        _reject_unknown(cls, obj, "ExperimentSpec JSON")
        obj = dict(obj)
        if isinstance(obj.get("scenario"), dict):
            obj["scenario"] = _scenario_from_json(obj["scenario"])
        if isinstance(obj.get("dealer_tamper"), dict):
            obj["dealer_tamper"] = {
                int(k): (str(mode), int(rnd))
                for k, (mode, rnd) in obj["dealer_tamper"].items()}
        return cls(**obj)


def _scenario_from_json(obj: dict):
    """Rebuild a ``ScenarioConfig`` (and its churn, straggler and dealer
    configs) from plain JSON, rejecting unknown keys."""
    from repro_torch.fl.scenarios import (ChurnConfig, DealerConfig,
                                          ScenarioConfig, StragglerConfig)
    _reject_unknown(ScenarioConfig, obj, "ExperimentSpec scenario")
    obj = dict(obj)
    if isinstance(obj.get("churn"), dict):
        _reject_unknown(ChurnConfig, obj["churn"], "scenario churn")
        obj["churn"] = ChurnConfig(**obj["churn"])
    if isinstance(obj.get("straggler"), dict):
        _reject_unknown(StragglerConfig, obj["straggler"],
                        "scenario straggler")
        obj["straggler"] = StragglerConfig(**obj["straggler"])
    dealers = []
    for d in obj.get("dealers") or ():
        if isinstance(d, dict):
            _reject_unknown(DealerConfig, d, "scenario dealer")
            d = DealerConfig(**d)
        dealers.append(d)
    obj["dealers"] = tuple(dealers)
    return ScenarioConfig(**obj)


def make_transport(spec: ExperimentSpec, *, net=None, device="cuda",
                   **overrides):
    """Transport factory over a spec on ``device``: the counting
    simulation transport of ``spec.protocol``, or the wire transport
    (``backend="wire"``, its workers on ``device``), with the spec's
    fields (``overrides`` pass extra transport keywords through, e.g.
    ``start=``, ``log_dir=`` on the wire)."""
    if not isinstance(spec, ExperimentSpec):
        raise TypeError(
            f"make_transport wants an ExperimentSpec, got "
            f"{type(spec).__name__} — build one (or use "
            "fl.transport.make_transport for raw kwargs)")
    from repro_torch.fl.transport import make_transport as _factory
    if spec.backend == "wire":
        # the wire has no top-k: refuse it before a port is bound or a
        # worker spawned, as FLSimulation does (the wire's kwargs have no
        # compression field, so passing them on would drop it)
        if spec.compression() is not None:
            raise ValueError(WIRE_TOPK_REFUSED)
        kw = spec.wire_transport_kwargs()
        n = kw.pop("n")
        if net is not None:
            kw["net"] = net
        kw.update(overrides)
        return _factory(spec.protocol, n, backend="wire", device=device,
                        **kw)
    kw = dict(m=spec.m, b=spec.vote_batch, scheme=spec.scheme,
              seed=spec.seed, fp=spec.fp(),
              shamir_degree=spec.shamir_degree,
              chunk_elems=spec.chunk_elems,
              compression=spec.compression())
    if net is not None:
        kw["net"] = net
    if spec.protocol == "two_phase":
        kw.update(vss=spec.vss,
                  reelect_each_round=spec.reelect_each_round,
                  norm_bound=spec.norm_bound, cohort=spec.cohort,
                  dealer_tamper=spec.dealer_tamper)
    kw.update(overrides)
    return _factory(spec.protocol, spec.n, backend="sim", device=device,
                    **kw)
