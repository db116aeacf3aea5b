"""The port's cohort-sampled rounds against the JAX package.

Same pools, seeds and numpy updates into ``repro`` (JAX on the CPU) and
``repro_torch`` (``device="cpu"``):

* ``sample_cohort`` and ``assign_home`` return the reference's ids, one
  pool of 100,000 among the cases; churn of the rest of the pool keeps a
  party's rank, and an empty pool raises ``CohortExhaustedError``;
* a cohort round at n = 50, c = 8 for both schemes: the cohort, the
  committee, the mean (its float32 bits) and every phase counter equal
  to the reference's simulation, and the counters to the per-cohort
  closed forms;
* ``run_fedavg`` in cohort mode, with and without registry churn:
  outcomes and phase counters equal, parameters within 1e-6 (the local
  step is one float32 subtraction in both frameworks).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.fl import FLSimulation as JFLSimulation
from repro.fl import FedAvgConfig as JFedAvgConfig
from repro.fl import run_fedavg as j_run_fedavg
from repro.fl.cohort import assign_home as j_assign_home
from repro.fl.cohort import sample_cohort as j_sample_cohort
from repro_torch.core import committee as t_committee
from repro_torch.core import costmodel
from repro_torch.core.costmodel import CostParams
from repro_torch.fl import FedAvgConfig, FLSimulation, run_fedavg
from repro_torch.fl.cohort import (CohortConfig, CohortExhaustedError,
                                   assign_home, sample_cohort)

PARAM_TOL = 1e-6
N, C, M, B, D = 50, 8, 3, 10, 33
#: eligible pools of three rounds: the registry, then two churned pools
POOLS = [set(range(N)), set(range(N)) - {1, 5, 9, 30, 31},
         (set(range(N)) - {1, 5, 9, 13, 40}) | {5}]


@pytest.mark.parametrize("seed,round_index,pool,size", [
    (0, 0, range(100_000), 1000),
    (3, 5, range(0, 2000, 3), 25),
    (7, 300, range(N), C),
    (11, 2, [4, 9, 17], 5),
])
def test_sample_cohort_and_assign_home_match_reference(seed, round_index,
                                                       pool, size):
    want = j_sample_cohort(pool, size, seed, round_index)
    got = sample_cohort(pool, size, seed, round_index, device="cpu")
    assert got == want and all(type(i) is int for i in got)
    committee = (want[-1], want[0], want[len(want) // 2])
    assert assign_home(got, committee, seed, round_index, device="cpu") \
        == j_assign_home(want, committee, seed, round_index)


def test_churn_keeps_ranks_and_an_empty_pool_raises():
    pool = set(range(5000))
    before = sample_cohort(pool, 100, 4, 1, device="cpu")
    gone = set(range(0, 5000, 7))
    after = sample_cohort(pool - gone, 100, 4, 1, device="cpu")
    # a survivor of the smaller pool that ranked in still ranks in
    assert set(before) - gone <= set(after)
    assert after == j_sample_cohort(pool - gone, 100, 4, 1)
    with pytest.raises(CohortExhaustedError, match="no eligible parties"):
        sample_cohort(set(), 3, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="negative party id"):
        sample_cohort([3, -1, 4, 5], 2, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        CohortConfig(size=0)


def _phases(net):
    return {k: (v.msg_num, v.msg_size) for k, v in net.phases.items()}


def _cohort_rounds(make_sim, to_array):
    sim = make_sim()
    tr = sim.transports["two_phase"]
    rng = np.random.RandomState(0)
    out = []
    for pool in POOLS:
        sim.elect_committee(eligible=pool)
        ids = tr.cohort_ids
        flats = rng.randn(len(ids), D).astype(np.float32)
        mean, _ = sim.aggregate("two_phase", to_array(flats), party_ids=ids)
        out.append({"cohort": ids, "committee": tuple(tr.committee),
                    "mean": np.asarray(mean, np.float32).view(np.uint32),
                    "phases": _phases(sim.net)})
    return out


@pytest.mark.parametrize("scheme", ["additive", "shamir"])
def test_cohort_round_matches_reference(scheme):
    kw = dict(m=M, b=B, seed=2, cohort=C, scheme=scheme)
    want = _cohort_rounds(lambda: JFLSimulation(N, **kw), jnp.asarray)
    got = _cohort_rounds(lambda: FLSimulation(N, device="cpu", **kw),
                         torch.from_numpy)
    assert got[0]["cohort"] == j_sample_cohort(range(N), C, 2, 0)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["cohort"] == w["cohort"]
        assert g["committee"] == w["committee"]
        assert set(g["committee"]) <= set(g["cohort"]) <= POOLS[r]
        np.testing.assert_array_equal(g["mean"], w["mean"])
        assert g["phases"] == w["phases"]
    subrounds = sum(t_committee.elect_among(g["cohort"], M, B, 2 + r,
                                            device="cpu").rounds
                    for r, g in enumerate(got))
    p = CostParams(n=N, e=len(POOLS), s=D, m=M, b=B)
    phases = got[-1]["phases"]
    assert phases["phase1"] == (subrounds * 2 * C * (C - 1),
                                subrounds * 2 * C * (C - 1) * B)
    p2 = [phases[k] for k in ("phase2_upload", "phase2_exchange",
                              "phase2_broadcast")]
    assert sum(x[0] for x in p2) == costmodel.phase2_cohort_msg_num(p, C)
    assert sum(x[1] for x in p2) == costmodel.phase2_cohort_msg_size(p, C)
    sim = FLSimulation(N, m=M, b=B, device="cpu")
    assert sim.expected_costs(D, 3, cohort=C) == \
        JFLSimulation(N, m=M, b=B).expected_costs(D, 3, cohort=C)


def test_stray_uploader_and_an_all_banned_pool_raise():
    sim = FLSimulation(10, m=3, seed=0, cohort=4, device="cpu")
    tr = sim.transports["two_phase"]
    sim.elect_committee()
    assert tr.cohort_ids == j_sample_cohort(range(10), 4, 0, 0)
    stray = next(i for i in range(10) if i not in tr.cohort_ids)
    ids = list(tr.cohort_ids[:3]) + [stray]
    with pytest.raises(ValueError, match="sampled cohort"):
        sim.aggregate("two_phase", torch.ones(4, 5), party_ids=ids)
    sim = FLSimulation(6, m=3, seed=0, cohort=3, device="cpu")
    sim.transports["two_phase"].evicted |= set(range(6))
    with pytest.raises(CohortExhaustedError):
        sim.elect_committee()
    with pytest.raises(CohortExhaustedError):
        sim.aggregate("two_phase", torch.ones(3, 4), party_ids=[0, 1, 2])
    with pytest.raises(ValueError, match="cannot seat a committee"):
        FLSimulation(6, m=3, cohort=2, device="cpu")
    with pytest.raises(ValueError, match="must be in 1..n"):
        FLSimulation(6, m=3, cohort=7, device="cpu")


def _fedavg(run, cfg_cls, to_array, schedule, **kw):
    # the round test's shapes, so the reference's compiled ops are reused

    def step(params, batch):
        return {"w": params["w"] - 0.1 * batch}

    def batches(i, epoch, it):
        return to_array(np.full(D, 0.01 * (i + 1) + 0.003 * epoch,
                                dtype=np.float32))

    cfg = cfg_cls(n_parties=N, epochs=3, local_steps=1, committee=M,
                  seed=3, cohort=C, scheme="shamir")
    return run(cfg, {"w": to_array(np.zeros(D, dtype=np.float32))}, step,
               batches, membership_schedule=schedule, **kw)


@pytest.mark.parametrize("churn", [False, True])
def test_run_fedavg_cohort_matches_reference(churn):
    schedule = ((lambda e: set(range(N)) - set(range(e, N, 3)) - {7})
                if churn else None)
    want = _fedavg(j_run_fedavg, JFedAvgConfig, jnp.asarray, schedule)
    got = _fedavg(run_fedavg, FedAvgConfig, torch.from_numpy, schedule,
                  device="cpu")
    assert [o.alive for o in got.outcomes] == \
        [o.alive for o in want.outcomes]
    assert all(len(o.alive) == C for o in got.outcomes)
    assert got.phases == want.phases
    assert (got.msg_num, got.msg_size) == (want.msg_num, want.msg_size)
    np.testing.assert_allclose(got.params["w"].numpy(),
                               np.asarray(want.params["w"]),
                               rtol=0, atol=PARAM_TOL)
    if churn:
        # the cohorts came from the churned pools
        assert all(7 not in o.alive for o in got.outcomes)
