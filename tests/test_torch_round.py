"""The port's two-phase round and FedAvg against the JAX package.

Same numpy inputs, seeds and party ids into ``repro`` (JAX on the CPU,
``kernel_backend="ref"``) and ``repro_torch`` (``device="cpu"``).
Shares, member sums, decoded means, committees and message counters are
compared bit for bit (tolerance 0).  The FedAvg trajectory is compared
with an absolute tolerance of 1e-4 on the final parameters: local SGD
runs in another float order in the two frameworks, and one flipped
fixed-point rounding moves a mean by 2^-16/n.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import costmodel as j_cost
from repro.core.aggregation import SecureAggregator as JAgg
from repro.core.aggregation import flatten_pytree
from repro.data import fault_detection_party as j_fault_data
from repro.fl import FedAvgConfig as JFedAvgConfig
from repro.fl import run_fedavg as j_run_fedavg
from repro.fl.transport import (P2PTransport as JP2P,
                                PlainTransport as JPlain,
                                TwoPhaseTransport as JTwoPhase)
from repro.models import simple_nn as j_nn
from repro_torch.core import costmodel as t_cost
from repro_torch.core.aggregation import SecureAggregator as TAgg
from repro_torch.core.aggregation import flatten
from repro_torch.data import fault_detection_party
from repro_torch.fl import FLSimulation, FedAvgConfig, run_fedavg
from repro_torch.fl.transport import (P2PTransport, PlainTransport,
                                      TwoPhaseTransport)
from repro_torch.models import simple_nn

SCHEMES = ["additive", "shamir"]


def _flats(l, d, seed=0):
    x = (np.random.RandomState(seed).randn(l, d) * 0.5).astype(np.float32)
    x[0, :3] = [np.nan, np.inf, -0.5 / 65536]
    return x


def _u32(t):
    return np.asarray(t).astype(np.uint32)


def _bits(t):
    return np.asarray(t, dtype=np.float32).view(np.uint32)


def _aggs(scheme, degree=None):
    return (JAgg(scheme=scheme, m=3, shamir_degree=degree,
                 kernel_backend="ref"),
            TAgg(scheme=scheme, m=3, shamir_degree=degree, device="cpu"))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_aggregator_batch_paths_are_bit_identical(scheme):
    x = _flats(6, 256)
    ids = [0, 2, 5, 9, 11, 40]
    jagg, tagg = _aggs(scheme, degree=1 if scheme == "shamir" else None)
    kw = dict(seed=7, party_ids=ids, round_index=300)
    want = np.asarray(jagg.make_shares_batch(x[:3], elem_base=128,
                                             **dict(kw, party_ids=ids[:3])))
    got = tagg.make_shares_batch(x[:3], elem_base=128,
                                 **dict(kw, party_ids=ids[:3]))
    np.testing.assert_array_equal(_u32(got), want)
    jsum = np.asarray(jagg.sum_shares_batch(x, chunk=3, **kw))
    tsum = tagg.sum_shares_batch(x, chunk=3, **kw)
    np.testing.assert_array_equal(_u32(tsum), jsum)
    np.testing.assert_array_equal(
        _bits(tagg.reconstruct_mean(tsum, 6)),
        _bits(jagg.reconstruct_mean(jsum, 6)))
    if scheme == "shamir":
        # sub-threshold: degree 1 reconstructs from members 2 and 3
        np.testing.assert_array_equal(
            _bits(tagg.reconstruct_mean(tsum[[1, 2]], 6, points=(2, 3))),
            _bits(jagg.reconstruct_mean(jsum[[1, 2]], 6, points=(2, 3))))
    else:
        with pytest.raises(ValueError, match="Shamir-only"):
            tagg.reconstruct_mean(tsum, 6, points=(1, 2, 3))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_aggregate_stream_equals_whole_vector_and_reference(scheme):
    x = _flats(6, 512, seed=1)
    ids = [1, 3, 4, 8, 9, 10]
    degree = 1 if scheme == "shamir" else None
    jagg, tagg = _aggs(scheme, degree)
    rows = dict(member_rows=[0, 2], points=(1, 3)) \
        if scheme == "shamir" else {}
    kw = dict(seed=2, party_ids=ids, round_index=1, party_chunk=3, **rows)
    chunked = tagg.aggregate_stream(x, chunk_elems=256, **kw)
    whole = tagg.aggregate_stream(x, chunk_elems=512, **kw)
    np.testing.assert_array_equal(_bits(chunked), _bits(whole))
    want = jagg.aggregate_stream(jnp.asarray(x), chunk_elems=256, **kw)
    np.testing.assert_array_equal(_bits(chunked), _bits(want))
    # a lazy block source gives the same bits
    lazy = tagg.aggregate_stream(
        lambda p0, p1, e0, e1: x[p0:p1, e0:e1], d=512, chunk_elems=256,
        **kw)
    np.testing.assert_array_equal(_bits(lazy), _bits(chunked))


def _phase_counters(net):
    return {k: (v.msg_num, v.msg_size) for k, v in net.phases.items()}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_two_phase_round_with_dropouts_matches_reference(scheme):
    n, s = 6, 256
    kw = dict(m=3, scheme=scheme, seed=5, chunk=3,
              shamir_degree=1 if scheme == "shamir" else None)
    jtr = JTwoPhase(n, kernel_backend="ref", **kw)
    ttr = TwoPhaseTransport(n, device="cpu", **kw)
    assert ttr.elect() == jtr.elect()
    x = _flats(n, s, seed=2)
    # round 0: every party; round 1: parties 1, 2 and 4 dropped
    live = [0, 3, 5]
    rounds = [(x, None, {}), (x[live], live, {})]
    if scheme == "shamir":
        # round 2: a committee member down, degree 1 < m - 1
        rounds.append((x[live], live,
                       {"committee_dropout": [jtr.committee[1]]}))
    for r, (flats, ids, extra) in enumerate(rounds):
        want = jtr.aggregate(jnp.asarray(flats), ids, round_index=r, **extra)
        got = ttr.aggregate(torch.from_numpy(flats), ids, round_index=r,
                            **extra)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        err = np.abs(got.numpy()[3:] - flats[:, 3:].mean(0)).max()
        assert err <= 0.5 / 65536 + 1e-6
    assert _phase_counters(ttr.net) == _phase_counters(jtr.net)
    # closed forms: Eq. 3 per election round, then each round's legs
    l_m = [n * 3, len(live) * 3] + ([len(live) * 2]
                                     if scheme == "shamir" else [])
    exch = [2, 2] + ([1] if scheme == "shamir" else [])
    p = t_cost.CostParams(n=n, e=1, s=s, m=3, b=10)
    phases = _phase_counters(ttr.net)
    assert phases["phase1"][0] % t_cost.phase1_msg_num(p) == 0
    assert phases["phase2_upload"] == (sum(l_m), sum(l_m) * s)
    assert phases["phase2_exchange"] == (sum(exch), sum(exch) * s)
    assert phases["phase2_broadcast"] == (n * len(rounds),
                                          n * len(rounds) * s)


def test_full_rounds_equal_eqs_3_to_6():
    n, s, e = 6, 50, 2
    sim = FLSimulation(n, m=3, seed=1, device="cpu")
    sim.elect_committee()
    x = _flats(n, s)
    for _ in range(e):
        sim.aggregate_two_phase(list(torch.from_numpy(x)))
    p = t_cost.CostParams(n=n, e=e, s=s, m=3, b=10)
    want = t_cost.summary(p)
    assert want == j_cost.summary(j_cost.CostParams(n=n, e=e, s=s, m=3, b=10))
    assert sim.net.stats("phase1").msg_num == want["phase1_msg_num"]
    assert sim.phase2_stats().msg_num == want["phase2_msg_num"]
    assert sim.phase2_stats().msg_size == want["phase2_msg_size"]


@pytest.mark.parametrize("protocol", ["p2p", "plain"])
def test_p2p_and_plain_counters_match_reference(protocol):
    n, s = 5, 200
    ids = [0, 2, 3, 4]
    x = _flats(len(ids), s, seed=3)
    jcls, tcls = (JP2P, P2PTransport) if protocol == "p2p" else \
        (JPlain, PlainTransport)
    jtr = jcls(n, seed=4, kernel_backend="ref")
    ttr = tcls(n, seed=4, device="cpu")
    want = jtr.aggregate(jnp.asarray(x), ids)
    got = ttr.aggregate(torch.from_numpy(x), ids)
    assert _phase_counters(ttr.net) == _phase_counters(jtr.net)
    l = len(ids)
    factor = 2 if protocol == "p2p" else 1
    assert ttr.net.stats().msg_num == factor * l * (l - 1)
    assert ttr.net.stats().msg_size == factor * l * (l - 1) * s
    if protocol == "p2p":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        p = t_cost.CostParams(n=l, e=1, s=s)
        assert ttr.net.stats().msg_num == t_cost.p2p_msg_num(p)
    else:
        # a float32 mean: summation order may differ by a few ulp
        np.testing.assert_allclose(got.numpy()[3:], np.asarray(want)[3:],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["simple", "complex"])
def test_params_carry_over_from_jax(kind):
    init, _ = j_nn.make_model(kind)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))
    model = simple_nn.params_from_jax(tree, device="cpu")
    back = simple_nn.params_to_numpy(model)
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    flat_t, unflatten = flatten(dict(model.named_parameters()))
    flat_j, _ = flatten_pytree(tree)
    np.testing.assert_array_equal(flat_t.detach().numpy(),
                                  np.asarray(flat_j))
    x = np.random.RandomState(0).randn(5, 121).astype(np.float32)
    _, fwd = j_nn.make_model(kind)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(fwd(tree, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    assert {k: v.shape for k, v in unflatten(flat_t).items()} == \
        {k: v.shape for k, v in dict(model.named_parameters()).items()}


def test_fedavg_on_simple_nn_tracks_reference():
    n_parties, lr = 4, 0.1
    data = [j_fault_data(600, seed=0, party=p) for p in range(n_parties)]
    for p in range(n_parties):
        tx, ty = fault_detection_party(600, seed=0, party=p)
        np.testing.assert_array_equal(tx, data[p][0])
        np.testing.assert_array_equal(ty, data[p][1])

    def batches(i, e, it):
        x, y = data[i]
        idx = np.random.RandomState(e * 31 + it).choice(len(x), 64)
        return x[idx], y[idx]

    # the reference's step (benchmarks/accuracy.py:_step_fn)
    def loss(p, b):
        return j_nn.nll_loss(j_nn.forward_simple(p, b[0]), b[1])

    @jax.jit
    def j_step(p, b):
        g = jax.grad(loss)(p, (jnp.asarray(b[0]), jnp.asarray(b[1])))
        return jax.tree.map(lambda a, gg: a - lr * gg, p, g)

    init = j_nn.init_simple(jax.random.PRNGKey(0))
    jres = j_run_fedavg(JFedAvgConfig(n_parties=n_parties, epochs=3,
                                      seed=0), init, j_step, batches)
    model = simple_nn.params_from_jax(jax.tree.map(np.asarray, init),
                                      device="cpu")
    tres = run_fedavg(FedAvgConfig(n_parties=n_parties, epochs=3, seed=0),
                      model, simple_nn.sgd_step(model, lr), batches,
                      device="cpu")
    for k in ("w", "b"):
        np.testing.assert_allclose(tres.params[k].numpy(),
                                   np.asarray(jres.params[k]),
                                   rtol=0, atol=1e-4)
    assert (tres.msg_num, tres.msg_size) == (jres.msg_num, jres.msg_size)
    assert tres.phases == jres.phases
