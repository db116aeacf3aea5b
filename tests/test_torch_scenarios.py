"""The port's adversarial scenario harness against the JAX package.

* ``churn_schedule``, ``straggler_latencies`` and ``dirichlet_partition``
  return the reference's values (numpy, equal);
* ``expected_counters`` returns the reference's dict for the same
  outcomes (full participation, cohort mode, churn with blame);
* ``run_scenario`` on the CPU for four composed scenarios — non-IID
  splits under churn, stragglers, a ``scale`` dealer under the norm
  audit (``norm_bound`` 8.0) and a malformed dealer — each started from
  the reference's initial parameters: ``counters``,
  ``counters_expected``, ``counters_match``, ``banned``, ``outcomes``
  and ``aborted`` equal, and ``final_loss`` within ``LOSS_TOL``.  The
  local SGD steps run in another float order in the two frameworks
  (autograd against ``jax.grad``); the fixed-point mean absorbs most of
  that, and 1e-4 bounds what is left after three epochs.

How the reference is run: its scenarios use Feldman VSS, whose ladder
XLA on the CPU compiles for many minutes, so ``vss.gpow`` is replaced by
the exact table version of ``tests/test_torch_adversarial.py`` (held
equal to the ladder there).  Reference records are computed once per
module.
"""

import functools

import jax
import numpy as np
import pytest

from repro.core import vss as j_vss
from repro.data import dirichlet_partition as j_dirichlet_partition
from repro.fl import faults as j_faults
from repro.fl import scenarios as j_scenarios
from repro.models import simple_nn as j_nn
from repro_torch.data import dirichlet_partition
from repro_torch.fl import faults, scenarios

from test_torch_adversarial import _table_gpow

LOSS_TOL = 1e-4
_FAST = dict(local_steps=1, samples_per_party=60)
_STRAGGLER = dict(deadline_s=0.6, median_s=0.3, sigma=1.2, seed=7)
#: name -> ScenarioConfig keywords (nested configs as (class name, kw))
SCENARIOS = {
    "noniid_churn": dict(epochs=3, alpha=0.5, vss=False, scheme="additive",
                         shamir_degree=None,
                         churn=("ChurnConfig", dict(seed=3)), **_FAST),
    "stragglers": dict(epochs=3, vss=False,
                       straggler=("StragglerConfig", _STRAGGLER), **_FAST),
    "scale_dealer": dict(epochs=3, norm_bound=8.0,
                         dealers=(("DealerConfig",
                                   dict(party=3, mode="scale",
                                        round_index=1)),), **_FAST),
    "malformed_dealer": dict(epochs=2, norm_bound=8.0, expect_abort=True,
                             dealers=(("DealerConfig",
                                       dict(party=2, mode="malformed",
                                            round_index=1)),), **_FAST),
}
RECORD_KEYS = ("counters", "counters_expected", "counters_match", "banned",
               "outcomes", "aborted")


def _config(module, name):
    """The named scenario as ``module``'s ScenarioConfig."""
    def build(value):
        if isinstance(value, tuple) and value and isinstance(value[0], str):
            return getattr(module, value[0])(**value[1])
        if isinstance(value, tuple):
            return tuple(build(v) for v in value)
        return value
    kw = {k: build(v) for k, v in SCENARIOS[name].items()}
    return module.ScenarioConfig(name=name, **kw)


@functools.lru_cache(maxsize=None)
def _reference_init(model, seed):
    init, _ = j_nn.make_model(model)
    return {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(seed))
            .items()}


@functools.lru_cache(maxsize=None)
def _reference_record(name):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_vss, "gpow", _table_gpow)
        return j_scenarios.run_scenario(_config(j_scenarios, name))


@pytest.mark.parametrize("churn", [
    dict(seed=3), dict(leave_prob=0.9, rejoin_prob=0.2, min_parties=2,
                       seed=11),
    dict(leave_prob=0.6, rejoin_prob=1.0, min_parties=1, seed=5),
])
def test_churn_schedule_matches_reference(churn):
    for n, epochs in ((4, 5), (9, 8)):
        assert scenarios.churn_schedule(
            n, epochs, scenarios.ChurnConfig(**churn)) == \
            j_scenarios.churn_schedule(n, epochs,
                                       j_scenarios.ChurnConfig(**churn))


@pytest.mark.parametrize("straggler", [
    _STRAGGLER, dict(median_s=0.3, sigma=1.0, seed=0)])
def test_straggler_latencies_match_reference(straggler):
    assert scenarios.straggler_latencies(
        6, scenarios.StragglerConfig(**straggler)) == \
        j_scenarios.straggler_latencies(
            6, j_scenarios.StragglerConfig(**straggler))


@pytest.mark.parametrize("alpha,n_parties,seed", [
    (0.5, 4, 0), (0.1, 4, 0), (5.0, 7, 3)])
def test_dirichlet_partition_matches_reference(alpha, n_parties, seed):
    labels = np.random.RandomState(seed).randint(0, 3, size=200)
    got = dirichlet_partition(labels, n_parties, alpha=alpha, seed=seed)
    want = j_dirichlet_partition(labels, n_parties, alpha=alpha, seed=seed)
    assert len(got) == len(want) == n_parties
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _outcomes(module, n, blame_at):
    """Per-epoch outcomes: everyone alive, party ``n - 1`` dropped in
    epoch 1, and party 3 blamed as a dealer at ``blame_at``."""
    out = []
    for e in range(4):
        alive = set(range(n)) - ({n - 1} if e == 1 else set())
        o = module.RoundOutcome(alive=alive, dropped=set(alive) ^
                                set(range(n)), straggled=set())
        if e == blame_at:
            o.alive.discard(3)
            o.blamed_dealers = {3}
        out.append(o)
    return out


@pytest.mark.parametrize("kw,blame_at", [
    (dict(n=6), None), (dict(n=6, norm_bound=8.0), 1),
    (dict(n=30, cohort=6, norm_bound=8.0), 2),
    (dict(n=6, churn=("ChurnConfig", dict(seed=3)), norm_bound=8.0), 1),
])
def test_expected_counters_match_reference(kw, blame_at):
    def run(module, fl_faults, **extra):
        kw2 = dict(kw)
        churn = kw2.pop("churn", None)
        scn = module.ScenarioConfig(
            name="mirror", epochs=4,
            churn=(getattr(module, churn[0])(**churn[1]) if churn
                   else None), **kw2)
        members = (module.churn_schedule(scn.n, 4, scn.churn)
                   if scn.churn else None)
        return module.expected_counters(
            scn, 242, _outcomes(fl_faults, scn.n, blame_at), members,
            **extra)
    assert run(scenarios, faults, device="cpu") == run(j_scenarios,
                                                       j_faults)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_scenario_matches_reference(name):
    want = _reference_record(name)
    scn = _config(scenarios, name)
    got = scenarios.run_scenario(
        scn, init_params=_reference_init(scn.model, scn.seed), device="cpu")
    assert set(got) == set(want)
    for key in RECORD_KEYS:
        if key in want:                 # an aborted record has fewer
            assert got[key] == want[key], key
    if want["aborted"]:
        assert got["error"].split(":")[0] == want["error"].split(":")[0]
        assert got["error"] == want["error"]
    else:
        assert got["counters_match"]
        assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_TOL
        assert got["model_elems"] == want["model_elems"]
