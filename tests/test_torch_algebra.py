"""The port's algebra against the JAX reference and the numpy oracles.

Field, Philox, fixed point, additive and Shamir sharing, the committee
election and the cost model of ``repro_torch.core``, fed the same numpy
inputs as ``repro.core``.  Every comparison is bit-exact (tolerance 0):
integer words are compared as ``uint32``, floats by their bit patterns.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import additive as j_add
from repro.core import committee as j_com
from repro.core import costmodel as j_cost
from repro.core import field as j_field
from repro.core import fixed_point as j_fp
from repro.core import philox as j_philox
from repro.core import shamir as j_shamir
from repro_torch.core import additive as t_add
from repro_torch.core import committee as t_com
from repro_torch.core import costmodel as t_cost
from repro_torch.core import field as t_field
from repro_torch.core import fixed_point as t_fp
from repro_torch.core import philox as t_philox
from repro_torch.core import shamir as t_shamir

P = 0x7FFFFFFF
EDGES = [0, 1, 2, P - 1, P, P + 1, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _words(n, seed, hi=2 ** 32):
    rng = np.random.RandomState(seed)
    w = rng.randint(0, hi, size=n, dtype=np.uint64)
    return w.astype(np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.uint32).astype(np.int64))


def _pairs(hi):
    """Random operands below ``hi`` plus every pair of edge values."""
    edges = np.array([e for e in EDGES if e < hi], dtype=np.uint32)
    a, b = np.meshgrid(edges, edges)
    return (np.concatenate([a.ravel(), _words(500, 1, hi)]),
            np.concatenate([b.ravel(), _words(500, 2, hi)]))


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["ring_add", "ring_sub", "mullo32",
                                "mersenne_reduce", "to_field", "ring_neg"])
def test_ring_ops_match_reference(op):
    a, b = _pairs(2 ** 32)
    if op in ("mersenne_reduce", "to_field", "ring_neg"):
        want, got = getattr(j_field, op)(a), getattr(t_field, op)(_t(a))
    else:
        want, got = getattr(j_field, op)(a, b), getattr(t_field, op)(_t(a),
                                                                      _t(b))
    np.testing.assert_array_equal(_u32(got.numpy()), np.asarray(want))


def test_mulhilo32_matches_reference_and_uint64():
    a, b = _pairs(2 ** 32)
    hi, lo = t_field.mulhilo32(_t(a), _t(b))
    jhi, jlo = j_field.mulhilo32(a, b)
    np.testing.assert_array_equal(_u32(hi.numpy()), np.asarray(jhi))
    np.testing.assert_array_equal(_u32(lo.numpy()), np.asarray(jlo))
    full = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(hi.numpy().astype(np.uint64),
                                  full >> np.uint64(32))


@pytest.mark.parametrize("op", ["fadd", "fsub", "fmul", "fneg"])
def test_field_ops_match_reference(op):
    a, b = _pairs(P)
    if op == "fneg":
        want, got = j_field.fneg(a), t_field.fneg(_t(a))
    else:
        want = getattr(j_field, op)(a, b)
        got = getattr(t_field, op)(_t(a), _t(b))
    np.testing.assert_array_equal(_u32(got.numpy()), np.asarray(want))
    if op in ("fadd", "fmul"):
        oracle = getattr(j_field, "np_" + op)(a, b)
        np.testing.assert_array_equal(_u32(got.numpy()), oracle)


def test_sums_and_word_carriers():
    x = _words(4 * 257, 3).reshape(4, 257)
    np.testing.assert_array_equal(
        _u32(t_field.ring_sum(_t(x), axis=0).numpy()),
        np.asarray(j_field.ring_sum(x, axis=0)))
    f = x % P
    np.testing.assert_array_equal(
        _u32(t_field.fsum(_t(f), axis=1).numpy()),
        np.asarray(j_field.fsum(f, axis=1)))
    bits = t_field.to_i32(_t(x))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), x)
    np.testing.assert_array_equal(_u32(t_field.u32(bits).numpy()), x)


# ---------------------------------------------------------------------------
# Philox
# ---------------------------------------------------------------------------

def test_philox_matches_numpy_oracles():
    ctr = _words(4 * 64, 4).reshape(64, 4)
    ctr[0] = 0xFFFFFFFF
    ctr[1] = 0
    for k0, k1 in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x1234567, 0xABCDEF)]:
        got = t_philox.philox_4x32(_t(ctr), k0, k1).numpy()
        np.testing.assert_array_equal(_u32(got),
                                      j_philox.np_philox_4x32(ctr, k0, k1))
        np.testing.assert_array_equal(_u32(got),
                                      t_philox.np_philox_4x32(ctr, k0, k1))


@pytest.mark.parametrize("n,counter_hi,counter_base",
                         [(1, 0, 0), (37, 3, 5), (1000, 7, 2 ** 32 - 3)])
def test_random_bits_match_reference(n, counter_hi, counter_base):
    k0, k1 = j_philox.derive_key(11, 22)
    want = j_philox.random_bits(n, k0, k1, counter_hi=counter_hi,
                                counter_base=counter_base)
    got = t_philox.random_bits(n, int(k0), int(k1), counter_hi=counter_hi,
                               counter_base=counter_base)
    np.testing.assert_array_equal(_u32(got.numpy()), np.asarray(want))
    like = t_philox.random_bits_like(torch.zeros(n, 1), int(k0), int(k1),
                                     counter_hi, counter_base)
    np.testing.assert_array_equal(_u32(like.numpy().ravel()),
                                  np.asarray(want))


def test_derive_key_int_pair_and_batched_forms():
    # int form, with a stream id above 2^32 (the high word is used)
    for seed, stream in [(0, 0), (5, 2 ** 40 + 3), (2 ** 35 + 1, 77)]:
        want = j_philox.derive_key(seed, stream)
        got = t_philox.derive_key(seed, stream)
        assert tuple(int(w) for w in want) == tuple(int(w) for w in got)
    # pair form as make_shares_batch feeds it: round_index >= 256 puts a
    # non-zero high word next to the low stream word
    for round_index in (0, 255, 256, 70000):
        parties = (0, 3, 9999)
        lo_words = [((round_index << 24) & 0xFFFFFFFF) | p for p in parties]
        hi_word = (round_index << 24) >> 32
        got0, got1 = t_philox.derive_key(
            9, (torch.tensor(lo_words), hi_word))
        for i, p in enumerate(parties):
            want = j_philox.derive_key(9, (jnp.uint32(lo_words[i]), hi_word))
            as_int = t_philox.derive_key(9, (round_index << 24) | p)
            assert (int(want[0]), int(want[1])) == (int(got0[i]),
                                                    int(got1[i]))
            assert (int(as_int[0]), int(as_int[1])) == (int(got0[i]),
                                                        int(got1[i]))


# ---------------------------------------------------------------------------
# fixed point
# ---------------------------------------------------------------------------

SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0,
                    0.5 / 65536, 1.5 / 65536, -2.5 / 65536, 2.5 / 65536,
                    63.99999, 64.0, -64.0, 1e9, -1e9, 1e-30], np.float32)


@pytest.mark.parametrize("algebra", ["ring", "field"])
def test_encode_decode_match_reference(algebra):
    jcfg = j_fp.FixedPointConfig(algebra=algebra)
    tcfg = t_fp.FixedPointConfig(algebra=algebra)
    x = np.concatenate([SPECIAL,
                        np.random.RandomState(5).randn(500).astype(
                            np.float32) * 30])
    want = np.asarray(jcfg.encode(x))
    got = tcfg.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(want[finite],
                                  j_fp.np_encode(jcfg, x[finite]))
    np.testing.assert_array_equal(want[finite],
                                  t_fp.np_encode(tcfg, x[finite]))
    # NaN -> 0 and ties to even, as the reference's XLA bits
    assert int(got[0]) == 0
    assert [int(v) for v in got[5:9]] == [
        0, 2, (-2) % tcfg.modulus, 2]
    w = _words(300, 6) if algebra == "ring" else _words(300, 6, P)
    for n in (1, 3, 7):
        np.testing.assert_array_equal(
            tcfg.decode_mean(_t(w), n).numpy().view(np.uint32),
            np.asarray(jcfg.decode_mean(w, n)).view(np.uint32))


@pytest.mark.parametrize("frac_bits,clip,algebra,n_max",
                         [(16, 64.0, "ring", 511), (16, 64.0, "field", 255),
                          (10, 64.0, "ring", 32767),
                          (10, 64.0, "field", 16383)])
def test_max_parties_boundary(frac_bits, clip, algebra, n_max):
    tcfg = t_fp.FixedPointConfig(frac_bits, clip, algebra)
    jcfg = j_fp.FixedPointConfig(frac_bits, clip, algebra)
    assert tcfg.max_parties() == jcfg.max_parties() == n_max
    tcfg.validate_for_parties(n_max)
    with pytest.raises(ValueError, match="headroom"):
        tcfg.validate_for_parties(n_max + 1)
    # the worst case at the boundary decodes positive
    code = tcfg.encode(torch.full((n_max,), clip)).sum() % tcfg.modulus
    assert float(tcfg.decode(code)) == pytest.approx(n_max * clip)


# ---------------------------------------------------------------------------
# additive and Shamir sharing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,counter_base", [(1, 0), (3, 0), (4, 250),
                                            (5, 2 ** 32 - 1)])
def test_additive_share_matches_reference(m, counter_base):
    v = _words(601, 7)
    k0, k1 = j_philox.derive_key(3, 44)
    want = np.asarray(j_add.share(v, m, k0, k1, counter_base=counter_base))
    got = t_add.share(_t(v), m, int(k0), int(k1), counter_base=counter_base)
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    np.testing.assert_array_equal(_u32(t_add.reconstruct(got).numpy()), v)


@pytest.mark.parametrize("m,degree,counter_base",
                         [(3, None, 0), (5, 2, 128), (4, 0, 7), (6, 5, 33)])
def test_shamir_share_and_reconstruct_match_reference(m, degree,
                                                      counter_base):
    v = _words(509, 8, P)
    k0, k1 = j_philox.derive_key(4, 55)
    want = np.asarray(j_shamir.share(v, m, k0, k1, degree=degree,
                                     counter_base=counter_base))
    got = t_shamir.share(_t(v), m, int(k0), int(k1), degree=degree,
                         counter_base=counter_base)
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    d = m - 1 if degree is None else degree
    points = tuple(range(m - d, m + 1))   # the last d+1 points
    assert (t_shamir.lagrange_weights_at_zero(points)
            == j_shamir.lagrange_weights_at_zero(points))
    rows = got[[p - 1 for p in points]]
    rec = t_shamir.reconstruct(rows, points=points)
    np.testing.assert_array_equal(_u32(rec.numpy()), v)
    np.testing.assert_array_equal(
        _u32(rec.numpy()),
        np.asarray(j_shamir.reconstruct(want[[p - 1 for p in points]],
                                        points=points)))


def test_batched_keys_share_each_row_with_its_own_stream():
    v = _words(3 * 100, 9).reshape(3, 100)
    keys = [j_philox.derive_key(1, i) for i in range(3)]
    k0 = torch.tensor([int(k[0]) for k in keys])
    k1 = torch.tensor([int(k[1]) for k in keys])
    got = t_add.share(_t(v), 3, k0, k1, counter_base=12)
    for i, (a, b) in enumerate(keys):
        np.testing.assert_array_equal(
            _u32(got[:, i].numpy()),
            np.asarray(j_add.share(v[i], 3, a, b, counter_base=12)))


# ---------------------------------------------------------------------------
# committee election
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(n=40, m=3, b=10, seed=0),
    dict(n=40, m=5, b=2, seed=17),
    dict(n=40, m=3, b=10, seed=3, exclude=(1, 2, 5)),
    dict(n=40, m=4, b=10, seed=8, reputation={0: 0.5, 7: 0.0, 9: 2.0}),
])
def test_election_matches_reference(kwargs):
    want = j_com.elect(**kwargs)
    got = t_com.elect(**kwargs, device="cpu")
    assert got.committee == want.committee
    assert got.rounds == want.rounds
    np.testing.assert_array_equal(got.tally, want.tally)


def test_election_among_cohort_matches_reference():
    ids = [3, 17, 4, 99, 1000, 250, 7]
    want = j_com.elect_among(ids, 3, 4, seed=12, exclude=(17,))
    got = t_com.elect_among(ids, 3, 4, seed=12, exclude=(17,), device="cpu")
    assert (got.committee, got.rounds) == (want.committee, want.rounds)
    np.testing.assert_array_equal(got.tally, want.tally)
    k0, k1 = j_philox.derive_key(5, 6)
    np.testing.assert_array_equal(
        _u32(t_com.draw_votes(23, 10, int(k0), int(k1), 2).numpy()),
        np.asarray(j_com.draw_votes(23, 10, k0, k1, 2)))


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,s,m,b", [(4, 15, 242, 3, 10),
                                       (10_000, 1, 10_000, 3, 10),
                                       (57, 3, 7380, 5, 4)])
def test_costmodel_matches_reference(n, e, s, m, b):
    tp = t_cost.CostParams(n=n, e=e, s=s, m=m, b=b)
    jp = j_cost.CostParams(n=n, e=e, s=s, m=m, b=b)
    assert t_cost.summary(tp) == j_cost.summary(jp)
    assert t_cost.expand_eq7(tp) == t_cost.twophase_msg_num(tp)
    assert t_cost.expand_eq8(tp) == t_cost.twophase_msg_size(tp)
