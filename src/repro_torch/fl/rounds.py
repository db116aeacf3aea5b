"""FedAvg rounds over the simulation or the wire backend.

Counterpart of ``repro/fl/rounds.py``: per global epoch every live party
runs ``local_steps`` local iterations from the shared model, and the
local models are averaged under MPC (two-phase or P2P), with the
crash/straggler/elastic handling of ``fl.faults``, and the blame of the
malicious-secure round: a blamed member or dealer is banned for the rest
of the run and the committee is re-elected without it.  With ``cohort``
each round samples its cohort from the current membership and elects
over it (DESIGN.md §12); a pipelined wire coordinator gets the next
round's membership so its Phase I overlaps this round's Phase II.
Parameters are
dicts of tensors on the run's device; they flatten in sorted-key order,
as the reference's pytrees do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.aggregation import flatten
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.deprecation import warn_deprecated
from repro_torch.kernels import dispatch
from .cohort import sample_cohort
from .faults import RoundOutcome, apply_faults
from .simulation import FLSimulation
from .transport import check_kernel_backend


@dataclasses.dataclass
class FedAvgConfig:
    n_parties: int
    epochs: int = 15
    local_steps: int = 3
    committee: int = 3
    scheme: str = "additive"       # additive | shamir
    protocol: str = "two_phase"    # two_phase | p2p | plain
    vote_batch: int = 10
    seed: int = 0
    deadline_s: float | None = None
    #: top-k sparsification ratio (None/0 = off: the paper's dense
    #: baseline); per-party error-feedback residuals persist in the
    #: transport across rounds
    compress_topk: float | None = None
    error_feedback: bool = True
    #: element-chunk size of the streaming aggregation (None = whole
    #: vector; the bits are the same either way)
    chunk_elems: int | None = None
    # -- typed aggregation fields -------------------------------------------
    #: transport backend: "sim" or "wire" (party worker processes)
    backend: str = "sim"
    #: Feldman verifiable secret sharing (Shamir only — DESIGN.md §10)
    vss: bool = False
    shamir_degree: int | None = None
    fp: FixedPointConfig | None = None
    #: kept for the reference's field list; must stay None (the device
    #: picks the path)
    kernel_backend: str | None = None
    #: L2 norm bound of the dealer audit (needs vss — DESIGN.md §11)
    norm_bound: float | None = None
    #: injected dealer adversary {party: (mode, round)} (DESIGN.md §11)
    dealer_tamper: dict | None = None
    #: re-run Alg. 2 every epoch (implied by ``cohort``)
    reelect_each_round: bool = False
    #: extra options of the wire backend (ignored by the simulation)
    #: — ``log_dir=``, ``deadline_s=``, ``relay=``, ...
    wire_kwargs: dict | None = None
    #: per-round cohort size: ``n_parties`` becomes the registry and
    #: each round runs over a seeded sampled cohort (DESIGN.md §12)
    cohort: int | None = None
    #: DEPRECATED — extra aggregation kwargs for ``FLSimulation``; use
    #: the typed fields above (or ``repro_torch.api.ExperimentSpec``).
    #: Kept working behind a ``ReproDeprecationWarning`` with the same
    #: behaviour; an unknown key raises there with a did-you-mean hint
    agg_kwargs: dict | None = None

    def __post_init__(self):
        if self.compress_topk is not None and \
                not 0.0 <= self.compress_topk <= 1.0:
            raise ValueError(
                f"compress_topk={self.compress_topk} must be in [0, 1]")
        if self.backend not in ("sim", "wire"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             "expected 'sim' or 'wire'")
        check_kernel_backend(self.kernel_backend)

    def compression(self) -> CompressionConfig | None:
        if not self.compress_topk:
            return None
        return CompressionConfig(enabled=True,
                                 top_k_ratio=self.compress_topk,
                                 error_feedback=self.error_feedback)

    def simulation_kwargs(self) -> dict:
        """Aggregation kwargs for ``FLSimulation`` from the typed fields,
        with the deprecated ``agg_kwargs`` dict laid over them last (every
        key it sets wins, as before; it warns)."""
        kw = dict(backend=self.backend, vss=self.vss,
                  shamir_degree=self.shamir_degree, fp=self.fp,
                  kernel_backend=self.kernel_backend,
                  norm_bound=self.norm_bound,
                  dealer_tamper=self.dealer_tamper,
                  reelect_each_round=self.reelect_each_round,
                  wire_kwargs=self.wire_kwargs, cohort=self.cohort)
        if self.agg_kwargs:
            warn_deprecated(
                "FedAvgConfig.agg_kwargs is deprecated: use the typed "
                "FedAvgConfig fields (backend=, vss=, cohort=, ...) or "
                "repro_torch.api.ExperimentSpec")
            kw.update(self.agg_kwargs)
        return kw


@dataclasses.dataclass
class FedAvgResult:
    params: dict
    history: list
    msg_num: int
    msg_size: int
    wall_s: float
    outcomes: list
    #: parties banned mid-run by the transport's blame (tampering
    #: members and poisoning dealers); a banned party never rejoins, even
    #: if the membership schedule lists it again
    banned: set = dataclasses.field(default_factory=set)
    #: per-phase ``(msg_num, msg_size)`` of the run's ``Network``
    phases: dict = dataclasses.field(default_factory=dict)


def run_fedavg(cfg: FedAvgConfig, init_params, local_train_step: Callable,
               party_batches: Callable, eval_fn: Callable | None = None,
               latency_s: dict[int, float] | None = None,
               membership_schedule: Callable | None = None,
               device="cuda") -> FedAvgResult:
    """Generic FedAvg on ``device``.

    init_params: dict of tensors, or an ``nn.Module`` whose parameters
      start the run
    local_train_step(params, batch) -> params (one local iteration)
    party_batches(party, epoch, it) -> batch
    membership_schedule(epoch) -> set of live party ids (elastic)

    ``cfg`` may also be anything with ``fedavg_config()`` — a
    ``repro_torch.api.ExperimentSpec`` — which is resolved first.
    """
    if hasattr(cfg, "fedavg_config"):
        cfg = cfg.fedavg_config()
    device = dispatch.resolve_device(device)
    if isinstance(init_params, torch.nn.Module):
        init_params = dict(init_params.named_parameters())
    params = {k: torch.as_tensor(v).detach().to(device)
              for k, v in init_params.items()}
    sim = FLSimulation(cfg.n_parties, m=cfg.committee, scheme=cfg.scheme,
                       seed=cfg.seed, b=cfg.vote_batch,
                       chunk_elems=cfg.chunk_elems,
                       compression=cfg.compression(), device=device,
                       **cfg.simulation_kwargs())
    try:
        return _run_fedavg(cfg, sim, params, local_train_step,
                           party_batches, eval_fn, latency_s,
                           membership_schedule, device)
    finally:
        # the wire backend owns party worker processes and a server
        # thread; the simulation's close is a no-op
        sim.close()


def _run_fedavg(cfg, sim, params, local_train_step, party_batches, eval_fn,
                latency_s, membership_schedule, device) -> FedAvgResult:
    _, unflatten = flatten(params)
    # cohort mode (read off the transport, so the deprecated agg_kwargs
    # path sets it alike): each round elects over its sampled cohort
    # instead of the single and elastic elections
    cohort_size = (sim.transports["two_phase"].cohort
                   if cfg.protocol == "two_phase" else None)
    if cfg.protocol == "two_phase" and not cohort_size:
        sim.elect_committee()
    history, outcomes = [], []
    t0 = time.perf_counter()
    members = set(range(cfg.n_parties))
    banned: set[int] = set()

    for epoch in range(cfg.epochs):
        if membership_schedule is not None:
            # blame is sticky: a banned party never rejoins
            new_members = set(membership_schedule(epoch)) - banned
            if new_members != members:
                members = new_members
                if cfg.protocol == "two_phase" and not cohort_size:
                    sim.elect_committee()  # elastic re-election (Phase I)

        round_members = members
        if cohort_size:
            # this round's cohort from the current membership: the draw
            # the transport makes, so the loop and the transport agree
            sim.elect_committee(eligible=members)
            round_members = set(sim.transports["two_phase"].cohort_ids)
            assert round_members == set(sample_cohort(
                members, cohort_size, cfg.seed, epoch, device=device))

        committee = sim.committee if cfg.protocol == "two_phase" else None
        # reconstruction quorum: all m shares for additive, degree+1
        # for Shamir
        if cfg.scheme == "additive":
            threshold = cfg.committee
        else:
            degree = sim.transports["two_phase"].shamir_degree
            threshold = (cfg.committee - 1 if degree is None else degree) + 1
        try:
            outcome: RoundOutcome = apply_faults(
                round_members, latency_s or {}, cfg.deadline_s,
                seed=cfg.seed, round_index=epoch, committee=committee,
                reconstruct_threshold=threshold if committee else None)
        except ValueError:
            # an elastic shrink can leave the committee under-represented
            # in the membership; the committee role is share-index
            # metadata in this simulation, so the round proceeds without
            # the committee-quorum floor (as in the reference)
            outcome = apply_faults(
                round_members, latency_s or {}, cfg.deadline_s,
                seed=cfg.seed, round_index=epoch)
        outcomes.append(outcome)

        live = sorted(outcome.alive)
        locals_flat = []
        for i in live:
            p_i = params
            for it in range(cfg.local_steps):
                p_i = local_train_step(p_i, party_batches(i, epoch, it))
            locals_flat.append(flatten(p_i)[0])

        # survivors keep their original ids: party i always masks with
        # its own Philox stream regardless of who else dropped
        agg_kw = {}
        if cohort_size and epoch < cfg.epochs - 1:
            tr = sim.transports["two_phase"]
            if getattr(getattr(tr, "cfg", None), "pipeline", False):
                # pipelined wire coordinator: round r+1's expected
                # membership lets Phase I(r+1) overlap this Phase II.
                # Never on the last round: a speculative election no
                # round adopts would break the Eq. 3 counters
                nxt = members
                if membership_schedule is not None:
                    nxt = set(membership_schedule(epoch + 1)) - banned
                agg_kw["pipeline_next_eligible"] = nxt
        mean, _ = sim.aggregate(cfg.protocol, locals_flat, party_ids=live,
                                **agg_kw)

        if cfg.protocol == "two_phase":
            # fold the transport's blame (tampering members, poisoning
            # dealers) into the round's outcome, ban the offenders and
            # re-elect: the transport has evicted them from elections
            t_out = sim.transports["two_phase"].last_outcome
            newly = (set() if t_out is None
                     else (t_out.blamed | t_out.blamed_dealers) & members)
            if newly:
                outcome.blamed |= t_out.blamed & members
                outcome.blamed_dealers |= t_out.blamed_dealers & members
                outcome.alive -= newly
                banned |= newly
                members = members - newly
                if not cohort_size:
                    # cohort mode elects at the top of every round
                    sim.elect_committee()
        params = unflatten(mean)
        if eval_fn is not None:
            history.append(eval_fn(params, epoch))

    stats = sim.net.stats()
    return FedAvgResult(params=params, history=history,
                        msg_num=stats.msg_num, msg_size=stats.msg_size,
                        wall_s=time.perf_counter() - t0, outcomes=outcomes,
                        banned=banned,
                        phases={k: (st.msg_num, st.msg_size)
                                for k, st in sim.net.phases.items()})
