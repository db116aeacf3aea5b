"""The port's malicious-secure round and FedAvg against the JAX package.

Same numpy inputs, seeds and adversaries into ``repro`` (JAX on the CPU)
and ``repro_torch`` (``device="cpu"``), at the reference battery's own
size (``tests/test_vss_adversarial.py``: n = 4, s = 242, m = 3, degree
1).  Means, outcomes, evicted sets, next committees and counters are
compared bit for bit (tolerance 0); the FedAvg parameters within 1e-4,
the tolerance of ``tests/test_torch_round.py`` (local SGD runs in
another float order in the two frameworks).

How the reference is run: eagerly (``jax.disable_jit``), because XLA on
the CPU takes many minutes to compile the Feldman ladders, and with its
``vss.gpow`` replaced by ``_table_gpow``, the same fixed-base power
computed from four byte tables with the reference's own ``qmul``
(three products instead of thirty-one).  Both give the canonical
residue ``h^s mod q``; ``test_table_gpow_equals_the_reference_ladder``
holds them equal bit for bit.  Reference runs that several tests read
are computed once per module.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import committee as j_committee
from repro.core import vss as j_vss
from repro.data import fault_detection_party as j_fault_data
from repro.fl import FedAvgConfig as JFedAvgConfig
from repro.fl import make_transport as j_make_transport
from repro.fl import run_fedavg as j_run_fedavg
from repro.models import simple_nn as j_nn
from repro_torch.core import committee as t_committee
from repro_torch.core import costmodel
from repro_torch.fl import FedAvgConfig, FLSimulation, run_fedavg
from repro_torch.fl import make_transport as t_make_transport
from repro_torch.models import simple_nn

N, S, M, DEG, B = 4, 242, 3, 1, 10
VSS = dict(m=M, scheme="shamir", shamir_degree=DEG, seed=1, vss=True)

_TABLE = [pow(j_vss.VSS_GEN_INT, b << (8 * i), j_vss.VSS_Q_INT)
          for i in range(4) for b in range(256)]
_TABLE_HI = np.array([v >> 32 for v in _TABLE], dtype=np.uint32)
_TABLE_LO = np.array([v & 0xFFFFFFFF for v in _TABLE], dtype=np.uint32)


def _table_gpow(exponent):
    """``h^s`` over the low 31 bits of ``s``, from the tables
    ``h^(b 256^i)`` and the reference's ``qmul``."""
    s = jnp.asarray(exponent, jnp.uint32) & np.uint32(0x7FFFFFFF)
    parts = []
    for i in range(4):
        idx = ((s >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(jnp.int32)
        idx = idx + 256 * i
        parts.append((jnp.asarray(_TABLE_HI)[idx],
                      jnp.asarray(_TABLE_LO)[idx]))
    return j_vss.qmul(j_vss.qmul(parts[0], parts[1]),
                      j_vss.qmul(parts[2], parts[3]))


@contextlib.contextmanager
def _reference():
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(j_vss, "gpow", _table_gpow)
        yield


def _flats(scale=1.0):
    return (np.random.RandomState(0).randn(N, S) * scale).astype(np.float32)


def _bits(t):
    return np.asarray(t, dtype=np.float32).view(np.uint32)


def _counters(tr):
    return {k: (v.msg_num, v.msg_size) for k, v in tr.net.phases.items()}


def _record(tr, mean):
    return {"mean": _bits(mean),
            "outcome": dataclasses.asdict(tr.last_outcome),
            "evicted": set(tr.evicted), "counters": _counters(tr)}


def _victim(round_index):
    """A non-final member of round ``round_index``'s committee (per-round
    re-election elects with seed + round)."""
    return j_committee.elect(N, M, B, 1 + round_index).committee[0]


def _run(make, to_tensor, rounds, tamper, **kw):
    """Rounds 0..len(rounds)-1, ``tamper`` at the last; then the next
    committee."""
    tr = make("two_phase", N, reelect_each_round=True, **VSS, **kw)
    recs = []
    for r in range(rounds):
        extra = {"committee_tamper": tamper} if tamper and \
            r == rounds - 1 else {}
        recs.append(_record(tr, tr.aggregate(to_tensor(_flats()),
                                             round_index=r, **extra)))
    tr.elect(rounds)
    recs[-1]["next_committee"] = tr.committee
    return recs


@functools.lru_cache(maxsize=None)
def _reference_run(rounds, mode):
    tamper = {_victim(rounds - 1): mode} if mode else None
    with _reference():
        return _run(j_make_transport, jnp.asarray, rounds, tamper,
                    kernel_backend="ref")


def _port_run(rounds, mode, **kw):
    tamper = {_victim(rounds - 1): mode} if mode else None
    return _run(t_make_transport, torch.from_numpy, rounds, tamper,
                device="cpu", **kw)


def test_table_gpow_equals_the_reference_ladder():
    rng = np.random.RandomState(5)
    s = np.concatenate([
        np.array([0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                 dtype=np.uint32),
        rng.randint(0, 2 ** 32, size=249, dtype=np.uint64)
        .astype(np.uint32)])
    want = j_vss.gpow(jnp.asarray(s))
    got = _table_gpow(jnp.asarray(s))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_honest_vss_round_and_counters_match_reference():
    # round 0 of the replay trajectory is honest
    want = _reference_run(2, "replay")[0]
    got = _port_run(2, "replay")[0]
    np.testing.assert_array_equal(got["mean"], want["mean"])
    assert got["outcome"] == want["outcome"]
    assert got["counters"] == want["counters"]
    # VSS only adds the commitment legs: the mean is the non-VSS one
    plain = t_make_transport("two_phase", N, m=M, scheme="shamir",
                             shamir_degree=DEG, seed=1, device="cpu")
    np.testing.assert_array_equal(
        _bits(plain.aggregate(torch.from_numpy(_flats()))), got["mean"])
    p = costmodel.CostParams(n=N, e=1, s=S, m=M, b=B)
    rounds = t_committee.elect(N, M, B, 1, device="cpu").rounds
    assert got["counters"]["phase2_commit"] == (
        costmodel.phase2_commit_msg_num(p),
        costmodel.phase2_commit_msg_size(p, DEG))
    assert got["counters"]["phase1"] == (
        rounds * costmodel.phase1_msg_num(p),
        rounds * costmodel.phase1_msg_size(p))


@pytest.mark.parametrize("mode", ["flip", "wrong_poly", "replay"])
def test_tamper_is_blamed_evicted_and_reelected_like_reference(mode):
    rounds = 2 if mode == "replay" else 1
    want = _reference_run(rounds, mode)
    got = _port_run(rounds, mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["mean"], w["mean"])
        assert g["outcome"] == w["outcome"]
        assert g["evicted"] == w["evicted"]
        assert g["counters"] == w["counters"]
    victim = _victim(rounds - 1)
    assert got[-1]["outcome"]["blamed"] == {victim}
    assert got[-1]["evicted"] == {victim}
    assert got[-1]["next_committee"] == want[-1]["next_committee"]
    assert victim not in got[-1]["next_committee"]
    # the tampered round's mean is the honest one
    honest = _port_run(rounds, None)
    np.testing.assert_array_equal(got[-1]["mean"], honest[-1]["mean"])


def test_two_colluding_tamperers_raise():
    """degree + 1 verified rows are needed: with two of three members
    tampering the round raises, as the reference's does
    (``tests/test_vss_adversarial.py``), and evicts nobody."""
    tr = t_make_transport("two_phase", N, **VSS, device="cpu")
    tr.elect()
    tamper = {tr.committee[0]: "flip", tr.committee[1]: "wrong_poly"}
    with pytest.raises(ValueError, match="only 1 committee rows verified"):
        tr.aggregate(torch.from_numpy(_flats()), round_index=0,
                     committee_tamper=tamper)
    assert tr.evicted == set()


def test_chunked_vss_round_matches_reference_whole_vector():
    """Verification rides the element chunks: chunks of 128 give the
    reference's whole-vector round, tamper included."""
    (want,) = _reference_run(1, "flip")
    (got,) = _port_run(1, "flip", chunk_elems=128)
    np.testing.assert_array_equal(got["mean"], want["mean"])
    assert got["outcome"] == want["outcome"]
    assert got["outcome"]["blamed"]


def _audit_round(make, to_tensor, dealer_tamper, **kw):
    tr = make("two_phase", N, norm_bound=8.0, dealer_tamper=dealer_tamper,
              **VSS, **kw)
    tr.elect()
    # honest norm ~0.8 (0.05 * sqrt(242)); a x32 poison ~25 > 8
    return _record(tr, tr.aggregate(to_tensor(_flats(0.05)),
                                    round_index=0))


def test_norm_audit_blames_the_same_dealers():
    dealers = {1: ("scale", 0), 2: ("sign_flip", 0)}
    with _reference():
        want = _audit_round(j_make_transport, jnp.asarray, dealers,
                            kernel_backend="ref")
    got = _audit_round(t_make_transport, torch.from_numpy, dealers,
                       device="cpu")
    assert want["outcome"]["blamed_dealers"] == {1, 2}
    np.testing.assert_array_equal(got["mean"], want["mean"])
    assert got["outcome"] == want["outcome"]
    assert got["evicted"] == want["evicted"]
    assert got["counters"] == want["counters"]
    p = costmodel.CostParams(n=N, e=1, s=S, m=M, b=B)
    assert got["counters"]["phase2_audit"] == (
        costmodel.phase2_audit_msg_num(p), costmodel.phase2_audit_msg_size(p))


def test_malformed_dealer_raises():
    """A dealer whose shares do not match its own commitments fails the
    round, as the reference's does (``tests/test_scenarios.py``)."""
    dealers = {2: ("malformed", 0)}
    with pytest.raises(ValueError, match="dealer share verification "
                                         r"failed for parties \[2\]"):
        _audit_round(t_make_transport, torch.from_numpy, dealers,
                     device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(scheme="additive", vss=True), "Shamir"),
    (dict(scheme="shamir", norm_bound=1.0), "vss"),
    (dict(scheme="shamir", vss=True, norm_bound=0.0), "positive"),
    (dict(scheme="shamir", dealer_tamper={0: ("malformed", 0)}), "vss"),
    (dict(scheme="shamir", vss=True, dealer_tamper={9: ("scale", 0)}),
     "out-of-range"),
    (dict(scheme="shamir", vss=True, dealer_tamper={0: ("x", 0)}),
     "unknown dealer"),
])
def test_malicious_knob_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        j_make_transport("two_phase", N, m=M, **kw)
    with pytest.raises(ValueError, match=match):
        t_make_transport("two_phase", N, m=M, device="cpu", **kw)


def test_committee_tamper_needs_vss_and_a_live_member():
    tr = t_make_transport("two_phase", N, m=M, scheme="shamir",
                          shamir_degree=DEG, seed=1, device="cpu")
    tr.elect()
    with pytest.raises(ValueError, match="vss"):
        tr.aggregate(torch.from_numpy(_flats()),
                     committee_tamper={tr.committee[0]: "flip"})
    tr = t_make_transport("two_phase", N, **VSS, device="cpu")
    tr.elect()
    outsider = (set(range(N)) - set(tr.committee)).pop()
    with pytest.raises(ValueError, match="not live members"):
        tr.aggregate(torch.from_numpy(_flats()),
                     committee_tamper={outsider: "flip"})
    sim = FLSimulation(N, **VSS, device="cpu")
    sim.elect_committee()
    victim = sim.committee[1]
    mean, _ = sim.aggregate_two_phase(list(torch.from_numpy(_flats())),
                                      committee_tamper={victim: "flip"})
    assert sim.transports["two_phase"].last_outcome.blamed == {victim}


def test_fedavg_with_poisoned_dealer_bans_like_reference():
    n_parties, lr, epochs = N, 0.1, 1
    data = [j_fault_data(600, seed=0, party=p) for p in range(n_parties)]

    def batches(i, e, it):
        x, y = data[i]
        idx = np.random.RandomState(e * 31 + it).choice(len(x), 64)
        return x[idx], y[idx]

    def loss(p, b):
        return j_nn.nll_loss(j_nn.forward_simple(p, b[0]), b[1])

    def j_step(p, b):
        g = jax.grad(loss)(p, (jnp.asarray(b[0]), jnp.asarray(b[1])))
        return jax.tree.map(lambda a, gg: a - lr * gg, p, g)

    init = j_nn.init_simple(jax.random.PRNGKey(0))
    norm = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(v))))
                             for v in jax.tree.leaves(init))))
    # honest parameter vectors stay near the initial norm; a x32 poison
    # is far above twice of it
    cfg = dict(n_parties=n_parties, epochs=epochs, local_steps=1, seed=0,
               scheme="shamir", shamir_degree=DEG, vss=True,
               norm_bound=2 * norm, dealer_tamper={3: ("scale", 0)})
    with _reference():
        jres = j_run_fedavg(JFedAvgConfig(**cfg), init, j_step, batches)
    model = simple_nn.params_from_jax(jax.tree.map(np.asarray, init),
                                      device="cpu")
    tres = run_fedavg(FedAvgConfig(**cfg), model,
                      simple_nn.sgd_step(model, lr), batches, device="cpu")
    assert jres.banned == {3}
    assert tres.banned == jres.banned
    assert [o.blamed_dealers for o in tres.outcomes] == \
        [o.blamed_dealers for o in jres.outcomes]
    assert [o.alive for o in tres.outcomes] == \
        [o.alive for o in jres.outcomes]
    for k in ("w", "b"):
        np.testing.assert_allclose(tres.params[k].numpy(),
                                   np.asarray(jres.params[k]),
                                   rtol=0, atol=1e-4)
    assert tres.phases == jres.phases
