"""Adversarial scenario harness (DESIGN.md §11).

Counterpart of ``repro/fl/scenarios.py``, on the simulation or the
wire backend: named, seed-reproducible compositions of the stressors
the port models one at a time —

* **churn** — per-round party arrival and departure (elastic
  membership, Alg. 2 re-election on every change);
* **non-IID data** — Dirichlet label splits (``data.dirichlet_partition``)
  of the pooled fault-detection corpus;
* **stragglers** — lognormal per-party latencies against the deadline;
* **malicious dealers** — poisoned (scaled or sign-flipped) or malformed
  updates, caught by the Feldman VSS layer and the norm-bound audit and
  banned through dealer blame.

A :class:`ScenarioConfig` is pure data; :func:`run_scenario` trains
SimpleNN (autograd SGD at lr 0.1, as the reference's ``jax.grad`` step)
through ``run_fedavg`` on ``device`` and returns the reference's record
(schema_version 1, the same keys): final accuracy and loss, wall time,
per-phase counters against the closed forms of Eqs. 3–6 replayed over
the run's live sets (:func:`expected_counters`), and every round's
outcome.  The reference starts from ``init(jax.random.PRNGKey(seed))``,
which the port cannot draw: pass ``init_params`` (the reference's
parameters, or a module) to start from the same point; without it the
port's own seeded init is used.  ``backend="wire"`` runs the same
rounds through party worker processes on ``device`` (``repro_torch.net``)
with the reference's patient wire defaults.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import committee as committee_mod
from repro_torch.core.aggregation import flatten
from repro_torch.data import dirichlet_partition, fault_detection_party
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import simple_nn

from .cohort import sample_cohort
from .faults import DEALER_TAMPER_MODES
from .rounds import FedAvgConfig, run_fedavg

__all__ = [
    "ChurnConfig", "DealerConfig", "ScenarioConfig", "StragglerConfig",
    "churn_schedule", "expected_counters", "run_scenario",
    "straggler_latencies",
]

#: counter phases the Eq. 3–6 mirror predicts exactly
MIRRORED_PHASES = ("phase1", "phase2_upload", "phase2_commit",
                   "phase2_exchange", "phase2_audit", "phase2_broadcast")
#: learning rate of the local SGD step (the reference's ``_step_fn``)
LOCAL_LR = 0.1


# ---------------------------------------------------------------------------
# Stressor configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Seeded per-epoch arrival and departure: every epoch after the
    first, each present party leaves with ``leave_prob`` (never below
    ``min_parties`` present) and each absent party returns with
    ``rejoin_prob``; a pure function of ``(n, epochs, seed)``."""

    leave_prob: float = 0.3
    rejoin_prob: float = 0.5
    min_parties: int = 2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    """Lognormal per-party latency ``exp(N(log(median_s), sigma))``,
    drawn once per run from ``seed``; a party over ``deadline_s``
    straggles every round (committee members are resurrected by the
    quorum rule)."""

    deadline_s: float = 1.0
    median_s: float = 0.3
    sigma: float = 1.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DealerConfig:
    """One malicious dealer: ``party`` applies ``mode`` at ``round_index``
    (``scale``/``sign_flip``: honest shares of a poisoned value, caught
    by the norm audit; ``malformed``: a tampered share stream, caught by
    the per-dealer Feldman check, fatal to the round)."""

    party: int
    mode: str = "scale"
    round_index: int = 1

    def __post_init__(self):
        if self.mode not in DEALER_TAMPER_MODES:
            raise ValueError(
                f"mode {self.mode!r} not in {DEALER_TAMPER_MODES}")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One named, fully seeded adversarial scenario."""

    name: str
    n: int = 4
    m: int = 3
    epochs: int = 4
    local_steps: int = 2
    batch_size: int = 48
    seed: int = 0
    model: str = "simple"
    scheme: str = "shamir"
    shamir_degree: int | None = 1
    vss: bool = True
    vote_batch: int = 10
    #: per-party training samples pooled before partitioning
    samples_per_party: int = 150
    #: Dirichlet concentration (None = seeded IID shards)
    alpha: float | None = None
    churn: ChurnConfig | None = None
    straggler: StragglerConfig | None = None
    dealers: tuple = ()
    #: L2 bound of the dealer audit; None disables the audit leg
    norm_bound: float | None = None
    #: per-round cohort size (DESIGN.md §12); None = full participation
    cohort: int | None = None
    backend: str = "sim"           # sim | wire
    #: extra options of the wire backend
    wire_kwargs: dict | None = None
    #: also run a dealer-free twin and record its loss and accuracy
    honest_twin: bool = False
    #: the scenario is expected to abort (malformed dealer): the record
    #: captures the failure instead of raising it
    expect_abort: bool = False

    def __post_init__(self):
        if self.backend not in ("sim", "wire"):
            raise ValueError(f"backend {self.backend!r} not sim|wire")
        for d in self.dealers:
            if not 0 <= d.party < self.n:
                raise ValueError(
                    f"dealer party {d.party} outside range({self.n})")
        if self.churn is not None \
                and not 1 <= self.churn.min_parties <= self.n:
            raise ValueError(
                f"min_parties={self.churn.min_parties} outside "
                f"[1, {self.n}]")


# ---------------------------------------------------------------------------
# Seeded schedules
# ---------------------------------------------------------------------------

def churn_schedule(n: int, epochs: int, churn: ChurnConfig) -> list:
    """Membership per epoch as a list of frozensets (epoch 0 = all)."""
    members = set(range(n))
    out = [frozenset(members)]
    for epoch in range(1, epochs):
        rng = np.random.RandomState(churn.seed * 1000003 + epoch)
        # in sorted order, so the draw sequence is deterministic
        for i in range(n):
            if i in members:
                if len(members) > churn.min_parties \
                        and rng.random_sample() < churn.leave_prob:
                    members.discard(i)
            elif rng.random_sample() < churn.rejoin_prob:
                members.add(i)
        out.append(frozenset(members))
    return out


def straggler_latencies(n: int, straggler: StragglerConfig) -> dict:
    """Per-party lognormal latency draws, one per run."""
    rng = np.random.RandomState(straggler.seed * 7919 + 1)
    draws = np.exp(rng.normal(np.log(straggler.median_s),
                              straggler.sigma, size=n))
    return {i: float(draws[i]) for i in range(n)}


# ---------------------------------------------------------------------------
# Data pipeline: pooled corpus -> per-party shards
# ---------------------------------------------------------------------------

def _build_shards(scn: ScenarioConfig):
    """Pool the per-party fault-detection draws, then split IID or by
    Dirichlet(alpha) over labels.  An empty Dirichlet shard takes one
    sample from the largest shard, so every party can form a batch."""
    xs, ys = zip(*[fault_detection_party(scn.samples_per_party,
                                         seed=scn.seed, party=p)
                   for p in range(scn.n)])
    x, y = np.concatenate(xs), np.concatenate(ys)
    if scn.alpha is None:
        rng = np.random.RandomState(scn.seed)
        shards = [np.sort(a) for a in
                  np.array_split(rng.permutation(len(x)), scn.n)]
    else:
        shards = [np.asarray(s, dtype=np.int64) for s in
                  dirichlet_partition(y, scn.n, alpha=scn.alpha,
                                      seed=scn.seed)]
        for i, shard in enumerate(shards):
            if len(shard) == 0:
                donor = int(np.argmax([len(s) for s in shards]))
                shards[i] = shards[donor][:1]
                shards[donor] = shards[donor][1:]
    return x, y, shards


def _eval_set(scn: ScenarioConfig):
    """Held-out draws from every party's distribution (fresh seed)."""
    xs, ys = zip(*[fault_detection_party(scn.samples_per_party,
                                         seed=scn.seed + 7919, party=p)
                   for p in range(scn.n)])
    return np.concatenate(xs), np.concatenate(ys)


# ---------------------------------------------------------------------------
# Eq. 3–6 counter mirror
# ---------------------------------------------------------------------------

def expected_counters(scn: ScenarioConfig, d: int, outcomes,
                      memberships=None, device="cuda") -> dict:
    """Replay ``run_fedavg``'s election and blame state machine and return
    the exact per-phase ``(msg_num, msg_size)`` the run must have
    counted.

    With ``l_e`` dealers alive in epoch ``e``, each epoch contributes
    ``l_e·m`` uploads of ``s`` (and ``l_e·m`` commitment messages of
    ``(deg+1)·2·s`` under VSS), ``m−1`` chain exchanges of ``s``, ``m−1``
    audit forwards of ``l_e·s`` with the norm bound, and ``n``
    broadcasts of ``s``.  Phase I adds ``rounds·2·n·(n−1)`` messages of
    ``b`` per election, with the rounds from the same Alg. 2 the
    transports run (on ``device``), eviction and reputation included.
    With ``scn.cohort = c`` every epoch samples its cohort from the
    surviving membership and elects over it (``rounds·2·c·(c−1)``).
    """
    n, m, b = scn.n, scn.m, scn.vote_batch
    device = resolve_device(device)
    degree = (scn.shamir_degree if scn.shamir_degree is not None
              else m - 1)
    phases = {k: [0, 0] for k in MIRRORED_PHASES}

    def _bump(key, count, size):
        phases[key][0] += count
        phases[key][1] += count * size

    evicted: set[int] = set()
    reputation: dict[int, float] = {}

    def _elect(round_index):
        result = committee_mod.elect(n, m, b, scn.seed + round_index,
                                     exclude=evicted,
                                     reputation=reputation or None,
                                     device=device)
        _bump("phase1", result.rounds * 2 * n * (n - 1), b)

    def _elect_cohort(round_index, eligible):
        ids = sample_cohort(set(eligible) - evicted, scn.cohort, scn.seed,
                            round_index, device=device)
        result = committee_mod.elect_among(
            ids, m, b, scn.seed + round_index, exclude=evicted,
            reputation=reputation or None, device=device)
        c = len(ids)
        _bump("phase1", result.rounds * 2 * c * (c - 1), b)

    if not scn.cohort:
        _elect(0)                               # initial election
    members = set(range(n))
    banned: set[int] = set()
    for epoch, out in enumerate(outcomes):
        if memberships is not None:
            new_members = set(memberships[epoch]) - banned
            if new_members != members:
                members = new_members
                if not scn.cohort:
                    _elect(epoch)               # elastic re-election
        if scn.cohort:
            _elect_cohort(epoch, members)       # per-round cohort
        # run_fedavg folds the transport's blame into the outcome after
        # the round (alive -= blamed), so the dealers at aggregate time
        # are the final alive set and both blame sets
        l = len(out.alive | out.blamed | out.blamed_dealers)
        _bump("phase2_upload", l * m, d)
        if scn.vss:
            _bump("phase2_commit", l * m, (degree + 1) * 2 * d)
        _bump("phase2_exchange", m - 1, d)
        if scn.norm_bound is not None:
            _bump("phase2_audit", m - 1, l * d)
        _bump("phase2_broadcast", n, d)
        newly = (out.blamed | out.blamed_dealers) & members
        if newly:
            for w in newly:                     # the transport evicts
                evicted.add(int(w))
                reputation[int(w)] = 0.0
            banned |= newly
            members -= newly
            if not scn.cohort:
                _elect(epoch + 1)               # post-ban re-election
    return {k: tuple(v) for k, v in phases.items() if v[0]}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def _initial_model(scn: ScenarioConfig, init_params, device):
    """The scenario's starting module on ``device``: the port's own
    seeded init, overwritten by ``init_params`` (a module, or a dict of
    arrays such as the reference's parameters) when given."""
    model = simple_nn.make_model(scn.model, seed=scn.seed, device=device)
    if init_params is not None:
        if isinstance(init_params, torch.nn.Module):
            init_params = dict(init_params.named_parameters())
        with torch.no_grad():
            for name, p in model.named_parameters():
                v = init_params[name]
                p.copy_(v.detach() if isinstance(v, torch.Tensor)
                        else torch.as_tensor(np.array(v, np.float32)))
    return model


def run_scenario(scn, init_params=None, device="cuda") -> dict:
    """Execute one scenario on ``device`` and return its record.

    Accepts a :class:`ScenarioConfig`, or a ``repro_torch.api.
    ExperimentSpec`` whose ``scenario`` is set (the spec's shared fields
    override the scenario's).  ``init_params`` starts the model (see the
    module docstring).
    """
    if hasattr(scn, "scenario_config"):         # an ExperimentSpec
        scn = scn.scenario_config()
    device = resolve_device(device)
    x, y, shards = _build_shards(scn)
    ex, ey = _eval_set(scn)
    model = _initial_model(scn, init_params, device)
    step = simple_nn.sgd_step(model, lr=LOCAL_LR)

    def batches(i, e, it):
        shard = shards[i]
        rng = np.random.RandomState(
            (scn.seed * 131 + i) * 997 + e * 31 + it)
        idx = shard[rng.choice(len(shard), scn.batch_size)]
        return x[idx], y[idx]

    memberships = (churn_schedule(scn.n, scn.epochs, scn.churn)
                   if scn.churn is not None else None)
    latency = (straggler_latencies(scn.n, scn.straggler)
               if scn.straggler is not None else None)

    wire_kwargs = None
    if scn.backend == "wire":
        # the reference's patient wire defaults: no straggler deadline
        # (a party's first use of the device is not a straggle; the
        # protocol's EOF dropout detection stays on) and a long round
        # timeout
        wire_kwargs = {"deadline_s": None, "round_timeout_s": 600.0}
        wire_kwargs.update(scn.wire_kwargs or {})

    cfg = FedAvgConfig(
        n_parties=scn.n, epochs=scn.epochs, local_steps=scn.local_steps,
        committee=scn.m, scheme=scn.scheme, protocol="two_phase",
        vote_batch=scn.vote_batch, seed=scn.seed,
        deadline_s=(scn.straggler.deadline_s
                    if scn.straggler is not None else None),
        backend=scn.backend, vss=scn.vss,
        shamir_degree=(scn.shamir_degree if scn.scheme == "shamir"
                       else None),
        norm_bound=scn.norm_bound,
        dealer_tamper=({d.party: (d.mode, d.round_index)
                        for d in scn.dealers} if scn.dealers else None),
        wire_kwargs=wire_kwargs, cohort=scn.cohort)

    params0 = {k: v.detach() for k, v in model.named_parameters()}
    d = int(flatten(params0)[0].shape[0])

    record = {
        "schema_version": 1,
        "name": scn.name,
        "backend": scn.backend,
        "n": scn.n, "m": scn.m, "epochs": scn.epochs, "seed": scn.seed,
        "model": scn.model, "model_elems": d,
        "alpha": scn.alpha,
        "churn": scn.churn is not None,
        "stragglers": scn.straggler is not None,
        "dealers": [{"party": dl.party, "mode": dl.mode,
                     "round": dl.round_index} for dl in scn.dealers],
        "norm_bound": scn.norm_bound,
        "cohort": scn.cohort,
        "aborted": False,
        "error": None,
    }

    t0 = time.perf_counter()
    try:
        res = run_fedavg(cfg, params0, step, batches,
                         latency_s=latency,
                         membership_schedule=(
                             (lambda e: memberships[e])
                             if memberships is not None else None),
                         device=device)
    except Exception as exc:  # noqa: BLE001 — an expected abort is data
        if not scn.expect_abort:
            raise
        record.update({
            "aborted": True,
            "error": f"{type(exc).__name__}: {exc}",
            "wall_s": round(time.perf_counter() - t0, 3),
        })
        return record
    if scn.expect_abort:
        raise AssertionError(
            f"scenario {scn.name!r} expected a protocol abort but the "
            "run completed")

    with torch.no_grad():
        logits = torch.func.functional_call(
            model, res.params, (torch.as_tensor(ex, device=device),))
        loss = float(simple_nn.nll_loss(logits,
                                        torch.as_tensor(ey, device=device)))
        pred = logits.argmax(-1).cpu().numpy()
    accuracy = _balanced_accuracy(pred, ey)

    expected = expected_counters(scn, d, res.outcomes, memberships,
                                 device=device)
    measured = {k: v for k, v in res.phases.items()
                if k in MIRRORED_PHASES}
    record.update({
        "wall_s": round(res.wall_s, 3),
        "round_wall_s": round(res.wall_s / scn.epochs, 3),
        "final_loss": round(loss, 6),
        "final_accuracy": round(accuracy, 4),
        "banned": sorted(res.banned),
        "outcomes": [_outcome_json(o) for o in res.outcomes],
        "counters": {k: list(v) for k, v in measured.items()},
        "counters_expected": {k: list(v) for k, v in expected.items()},
        "counters_match": measured == expected,
    })

    if scn.honest_twin and scn.dealers:
        twin = dataclasses.replace(scn, name=scn.name + "__honest_twin",
                                   dealers=(), honest_twin=False)
        twin_rec = run_scenario(twin, init_params=params0, device=device)
        record["honest_loss"] = twin_rec["final_loss"]
        record["honest_accuracy"] = twin_rec["final_accuracy"]
        record["loss_ratio_vs_honest"] = round(
            record["final_loss"] / max(twin_rec["final_loss"], 1e-12), 4)
    return record


def _balanced_accuracy(pred, y) -> float:
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    tn = int(((pred == 0) & (y == 0)).sum())
    recall = tp / max(tp + fn, 1)
    specificity = tn / max(tn + fp, 1)
    return 0.5 * (recall + specificity)


def _outcome_json(out) -> dict:
    return {"alive": sorted(out.alive), "dropped": sorted(out.dropped),
            "straggled": sorted(out.straggled),
            "blamed": sorted(out.blamed),
            "blamed_dealers": sorted(out.blamed_dealers)}
