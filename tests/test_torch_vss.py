"""The port's Feldman layer against the JAX package, bit for bit.

* F_q algebra: ``qadd``/``qmul``/``qpow_scalar``/``gpow`` of
  ``repro_torch.core.vss`` against ``repro.core.vss`` and the Python-int
  oracles, on edge values (0, 1, q-1, a hi limb of 2^27-1) and
  exponents 0, 1 and p-1;
* commitments: ``feldman_commit`` whole and chunked,
  ``aggregate_commits``, ``share_with_commitments`` and
  ``reconstruct_verified``;
* the plain version of the ``verify_shares`` kernel against the
  reference's ``verify_shares`` through its plain path (``forced="ref"``)
  at a ragged size (its Pallas kernel in interpret mode is not run here:
  interpret mode compiles the kernel body with XLA, which takes many
  minutes on the CPU);
* the fixed-base table of the CUDA kernel (``csrc/verify_shares.cu``);
* the VSS, audit and re-election forms of the cost model.

Every comparison is exact.  ``qadd``, ``qmul`` and short powers of the
reference run under ``jax.jit``; its ladders (``gpow``, ``qpow_scalar``
at p-1 and everything built on them) run eagerly (``jax.disable_jit``
where the reference jits them), because XLA on the CPU takes many
minutes to compile them.  The CUDA kernel itself runs only on a card:
``chip_smoke.py`` holds it against its plain version there.
"""

import functools
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import costmodel as j_cost
from repro.core import philox as j_philox
from repro.core import shamir as j_shamir
from repro.core import vss as j_vss
from repro.core.field import to_field as j_to_field
from repro.kernels.verify_shares import verify_shares as j_verify
from repro_torch.core import costmodel as t_cost
from repro_torch.core import philox as t_philox
from repro_torch.core import shamir as t_shamir
from repro_torch.core import vss as t_vss
from repro_torch.core.field import to_field as t_to_field
from repro_torch.kernels.verify_shares import verify_shares

Q = t_vss.VSS_Q_INT
P = 0x7FFFFFFF
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")

#: canonical elements: 0, 1, q-1, q-2, the largest hi limb with lo 0,
#: and random ones
EDGES = [0, 1, Q - 1, Q - 2, (2 ** 27 - 1) << 32, 2 ** 32, 2 ** 32 - 1]


def _elements(n=64, seed=0):
    rng = np.random.RandomState(seed)
    rand = [int(x) % Q for x in rng.randint(0, 2 ** 62, size=n - len(EDGES),
                                            dtype=np.int64)]
    return EDGES + rand


def _limbs(vals):
    """Python ints -> the reference's (hi, lo) uint32 pair."""
    return (jnp.asarray(np.array([v >> 32 for v in vals], dtype=np.uint32)),
            jnp.asarray(np.array([v & 0xFFFFFFFF for v in vals],
                                 dtype=np.uint32)))


def _ints(pair):
    hi, lo = (np.asarray(x).astype(object) for x in pair)
    return [int(h) * (1 << 32) + int(l) for h, l in zip(hi, lo)]


def _t(vals):
    return torch.tensor(vals, dtype=torch.int64)


def test_field_ops_match_reference_and_oracle():
    a = _elements()
    b = a[::-1]
    ja, jb = _limbs(a), _limbs(b)
    assert _ints(jax.jit(j_vss.qadd)(ja, jb)) == [(x + y) % Q
                                                  for x, y in zip(a, b)]
    assert t_vss.qadd(_t(a), _t(b)).tolist() == [(x + y) % Q
                                                 for x, y in zip(a, b)]
    want = _ints(jax.jit(j_vss.qmul)(ja, jb))
    assert want == [x * y % Q for x, y in zip(a, b)]
    assert t_vss.qmul(_t(a), _t(b)).tolist() == want
    for e in (0, 1, 3):
        want = _ints(jax.jit(lambda x, e=e: j_vss.qpow_scalar(x, e))(ja))
        assert want == [pow(x, e, Q) for x in a]
        assert t_vss.qpow_scalar(_t(a), e).tolist() == want
    # a 31-bit exponent: the reference's chain runs eagerly
    want = _ints(j_vss.qpow_scalar(ja, P - 1))
    assert want == [pow(x, P - 1, Q) for x in a]
    assert t_vss.qpow_scalar(_t(a), P - 1).tolist() == want


def test_gpow_matches_reference_ladder_and_oracle():
    rng = np.random.RandomState(1)
    s = np.concatenate([np.array([0, 1, 2, P - 1, P, 2 ** 31, 2 ** 32 - 1],
                                 dtype=np.uint32),
                        rng.randint(0, 2 ** 32, size=57, dtype=np.uint64)
                        .astype(np.uint32)])
    want = _ints(j_vss.gpow(jnp.asarray(s)))
    # the ladder uses the low 31 bits of the exponent
    assert want == [pow(t_vss.VSS_GEN_INT, int(x) & P, Q) for x in s]
    assert t_vss.gpow(torch.from_numpy(s.astype(np.int64))).tolist() == want
    # int32 bit patterns (the card's carrier) give the same powers
    assert t_vss.gpow(torch.from_numpy(s.view(np.int32))).tolist() == want
    assert t_vss.VSS_GEN_INT == j_vss.VSS_GEN_INT
    assert t_vss.VSS_ORDER_INT == j_vss.VSS_ORDER_INT == P
    np.testing.assert_array_equal(t_vss._GEN_POW, j_vss._GEN_POW)


def test_cuda_fixed_base_table_is_the_generator_ladder():
    src = (CSRC / "verify_shares.cu").read_text()
    body = src[src.index("kGenPow[31] = {"):]
    body = body[:body.index("};")]
    table = [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)ull", body)]
    assert table == [pow(t_vss.VSS_GEN_INT, 1 << i, Q) for i in range(31)]
    fq = (CSRC / "fq.cuh").read_text()
    assert "(1ull << 59) - (1ull << 28) + 1" in fq


def _keys(seed=7, stream=2):
    k0, k1 = j_philox.derive_key(seed, stream)
    return (k0, k1), (int(np.asarray(k0)), int(np.asarray(k1)))


def _codes(d, seed=0):
    return np.random.RandomState(seed).randint(0, P, size=d).astype(np.uint32)


def test_feldman_commit_whole_and_chunked_match_reference():
    jk, tk = _keys()
    v = _codes(384)
    want = np.asarray(j_vss.feldman_commit(jnp.asarray(v), *jk, degree=1))
    assert want.shape == (384, 2, 2)
    got = t_vss.feldman_commit(torch.from_numpy(v.astype(np.int64)), *tk,
                               degree=1)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    for off in (0, 256):     # counter_base 0 and 64
        chunk = t_vss.feldman_commit(
            torch.from_numpy(v[off:off + 128].astype(np.int64)), *tk,
            degree=1, counter_base=off // 4)
        np.testing.assert_array_equal(chunk.numpy().astype(np.uint32),
                                      want[off:off + 128])
    # the Python-int oracle of the same coefficients
    a1 = t_to_field(t_philox.random_bits(384, *tk, counter_hi=1))
    np.testing.assert_array_equal(
        a1.numpy(), np.asarray(j_to_field(j_philox.random_bits(
            384, *jk, counter_hi=1))).astype(np.int64))
    assert list(t_vss.to_int(got).ravel()) == \
        list(t_vss.np_commit([v.astype(np.int64), a1.numpy()]).ravel())


D = 242


@functools.lru_cache(maxsize=None)
def _dealer(i):
    """Dealer ``i``'s codewords, keys and the reference's shares and
    commitments at m = 3, degree 1 (one ragged size for every test, so
    the reference's eager ops compile once)."""
    jk, tk = _keys(4, i)
    v = _codes(D, seed=i)
    s, c = j_shamir.share_with_commitments(jnp.asarray(v), 3, *jk, degree=1)
    return v, tk, np.asarray(s), np.asarray(c)


def test_commitments_aggregate_and_verify_like_reference():
    d, m, deg = D, 3, 1
    j_sh, j_cm, t_sh, t_cm = [], [], [], []
    for i in range(3):
        v, tk, js, jc = _dealer(i)
        j_sh.append(js)
        j_cm.append(jc)
        s, c = t_shamir.share_with_commitments(
            torch.from_numpy(v.astype(np.int64)), m, *tk, degree=deg)
        np.testing.assert_array_equal(s.numpy().astype(np.uint32), j_sh[-1])
        np.testing.assert_array_equal(c.numpy().astype(np.uint32), j_cm[-1])
        t_sh.append(s)
        t_cm.append(c)
    want = np.asarray(j_vss.aggregate_commits(jnp.asarray(np.stack(j_cm))))
    got = t_vss.aggregate_commits(torch.stack(t_cm))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # the member sums verify against the aggregate; a flipped row fails
    rows = (t_sh[0] + t_sh[1] + t_sh[2]) % P
    for w in range(m):
        assert bool(t_vss.verify_share(rows[w], got, w + 1).all())
    bad = rows.clone()
    bad[1, 5] ^= 0x00FF00FF
    ok = t_vss.verify_share(bad[1], got, 2)
    assert not ok[5] and int(ok.sum()) == d - 1
    assert ok.tolist() == t_vss.np_verify_share(
        bad[1].numpy(), t_vss.to_int(got), 2).tolist()
    # reconstruct_verified drops the bad row, like the reference
    with jax.disable_jit():
        j_val, j_bad = j_shamir.reconstruct_verified(
            jnp.asarray(bad.numpy().astype(np.uint32)), jnp.asarray(want),
            (1, 2, 3), degree=deg)
    t_val, t_bad = t_shamir.reconstruct_verified(bad, got, (1, 2, 3),
                                                 degree=deg)
    assert t_bad == j_bad == (1,)
    np.testing.assert_array_equal(t_val.numpy().astype(np.uint32),
                                  np.asarray(j_val))
    bad[2, 0] ^= 1
    with pytest.raises(ValueError, match="verified"):
        t_shamir.reconstruct_verified(bad, got, (1, 2, 3), degree=deg)


def test_verify_shares_plain_version_matches_reference():
    """The plain version of the kernel at a ragged size with tampered
    elements, in both word carriers."""
    d = D
    _, _, shares, commits = _dealer(0)
    rows = shares.copy()
    rows[0, 33] ^= 0x00FF00FF
    rows[2, d - 1] = (rows[2, d - 1] + 9) % P
    with jax.disable_jit():
        want = np.asarray(j_verify(jnp.asarray(rows), jnp.asarray(commits),
                                   (1, 2, 3), forced="ref"))
    for carrier in (np.int64, np.int32):
        got = verify_shares(
            torch.from_numpy(rows.astype(np.int64).astype(carrier)),
            torch.from_numpy(commits.astype(np.int64).astype(carrier)),
            (1, 2, 3))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert not want[0, 33] and not want[2, d - 1]
    assert want.sum() == want.size - 2


def test_verify_shares_checks_shapes_like_reference():
    rows = torch.zeros((3, 8), dtype=torch.int64)
    commits = torch.zeros((8, 2, 2), dtype=torch.int64)
    for bad_rows, bad_commits, pts in (
            (rows[0], commits, (1, 2, 3)),
            (rows, commits[:7], (1, 2, 3)),
            (rows, commits[..., :1], (1, 2, 3)),
            (rows, commits, (1, 2))):
        with pytest.raises(ValueError):
            verify_shares(bad_rows, bad_commits, pts)
        with pytest.raises(ValueError):
            j_verify(jnp.asarray(bad_rows.numpy().astype(np.uint32)),
                     jnp.asarray(bad_commits.numpy().astype(np.uint32)),
                     pts)


@pytest.mark.parametrize("n,e,s,m,b,degree", [(4, 15, 242, 3, 10, None),
                                              (10_000, 1, 10_000, 3, 10, 1),
                                              (7, 3, 1000, 5, 4, 2)])
def test_vss_costmodel_matches_reference(n, e, s, m, b, degree):
    jp = j_cost.CostParams(n=n, e=e, s=s, m=m, b=b)
    tp = t_cost.CostParams(n=n, e=e, s=s, m=m, b=b)
    assert t_cost.summary_vss(tp, degree) == j_cost.summary_vss(jp, degree)
    for name in ("phase2_audit_elems", "phase2_audit_msg_num",
                 "phase2_audit_msg_size"):
        assert getattr(t_cost, name)(tp) == getattr(j_cost, name)(jp)
