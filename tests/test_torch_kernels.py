"""The port's kernel families against the JAX package's kernels.

Each plain PyTorch version (what a wrapper runs for a CPU tensor) is fed
the same numpy inputs as the reference's kernel entry points: through
the reference's plain path (``forced="ref"``) at a ragged size, and once
per kernel through the Pallas kernel itself in interpret mode at one
tiny grid, as the JAX package's own tests run it.  Every comparison is
bit-exact (tolerance 0; floats by their bit patterns).  The CUDA kernels
cannot run on a machine without a card: ``chip_smoke.py`` holds each of
them against its plain version on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import additive as j_add
from repro.core import philox as j_philox
from repro.core import shamir as j_shamir
from repro.core.fixed_point import FixedPointConfig as JFP
from repro.kernels.reconstruct import reconstruct as j_reconstruct
from repro.kernels.shamir import (shamir_reconstruct as j_shamir_rec,
                                  shamir_share_batch as j_shamir_share)
from repro.kernels.share_gen import (pad_to_tiles, share_gen_batch as j_sgb,
                                     unpad_flat)
from repro_torch.core.fixed_point import FixedPointConfig as TFP
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.kernels.reconstruct import reconstruct
from repro_torch.kernels.shamir import (shamir_reconstruct, shamir_share,
                                        shamir_share_batch)
from repro_torch.kernels.share_gen import share_gen, share_gen_batch
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.verify_shares import verify_shares

P = 0x7FFFFFFF
# (mode, parties, elements, element offset): the plain path at a ragged
# size with a non-zero chunk offset; interpret mode at one 8x128 tile
CASES = [("ref", 3, 1000, 256), ("interpret", 2, 1000, 0)]


def _flats(l, d, seed=0):
    x = (np.random.RandomState(seed).randn(l, d) * 20).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, 0.5 / 65536, 1.5 / 65536,
                -2.5 / 65536]
    return x


def _keys(l, seed=3):
    return np.stack([np.asarray(j_philox.derive_key(seed, 1000 + p),
                                dtype=np.uint32).ravel() for p in range(l)])


def _t_keys(keys):
    return torch.from_numpy(keys.astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("mode,l,d,elem_base", CASES)
def test_share_gen_batch_matches_reference(mode, l, d, elem_base):
    x, keys = _flats(l, d), _keys(l)
    tiled, dd = j_sgb(jnp.asarray(x), 3, jnp.asarray(keys), JFP(),
                      block_rows=8, layout="flat", forced=mode,
                      row_base=elem_base // 128)
    want = np.asarray(unpad_flat(tiled, dd))
    got = share_gen_batch(torch.from_numpy(x), 3, _t_keys(keys), TFP(),
                          counter_base=elem_base // 4)
    assert got.dtype == torch.int64 and tuple(got.shape) == (l, 3, d)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("mode,l,d,elem_base,m,degree",
                         [c + (3, None) for c in CASES] + [CASES[0] + (4, 1)])
def test_shamir_share_batch_matches_reference(mode, l, d, elem_base, m,
                                              degree):
    cfg_j, cfg_t = JFP(algebra="field"), TFP(algebra="field")
    x, keys = _flats(l, d, seed=1), _keys(l, seed=4)
    tiled, dd = j_shamir_share(jnp.asarray(x), m, jnp.asarray(keys), cfg_j,
                               degree=degree, block_rows=8, layout="flat",
                               forced=mode, row_base=elem_base // 128)
    want = np.asarray(unpad_flat(tiled, dd))
    got = shamir_share_batch(torch.from_numpy(x), m, _t_keys(keys), cfg_t,
                             degree=degree, counter_base=elem_base // 4)
    np.testing.assert_array_equal(_u32(got), want)


def _bits(t):
    return np.asarray(t, dtype=np.float32).view(np.uint32)


# The reference's kernel entry points are jitted, and XLA folds the
# unscale and the division by a constant n into one reciprocal multiply;
# the protocol calls them with n = 1 only and divides eagerly after
# (repro/core/aggregation.py:405-419).  So the kernels are held against
# them at n = 1, and the n > 1 decode against the eager decode_mean.

@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_reconstruct_matches_reference(mode):
    sums = np.random.RandomState(5).randint(
        0, 2 ** 32, size=(3, 1000), dtype=np.uint64).astype(np.uint32)
    sums[:, :2] = [[0x80000000, 0x7FFFFFFF], [0, 0], [0, 0]]
    tiled, dd = pad_to_tiles(jnp.asarray(sums), 8)
    want = unpad_flat(j_reconstruct(tiled, 1, JFP(), block_rows=8,
                                    forced=mode), dd)
    got = reconstruct(torch.from_numpy(sums.astype(np.int64)), 1, TFP())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if mode == "ref":
        eager = JFP().decode_mean(j_add.reconstruct(sums), 3)
        got3 = reconstruct(torch.from_numpy(sums.astype(np.int64)), 3, TFP())
        np.testing.assert_array_equal(_bits(got3), _bits(eager))


@pytest.mark.parametrize("mode,points", [("ref", None), ("ref", (1, 3)),
                                         ("interpret", (2, 3))])
def test_shamir_reconstruct_matches_reference(mode, points):
    cfg_j, cfg_t = JFP(algebra="field"), TFP(algebra="field")
    k = 3 if points is None else len(points)
    sums = np.random.RandomState(6).randint(
        0, P, size=(k, 1000), dtype=np.uint64).astype(np.uint32)
    sums[:, :4] = [0, P - 1, P // 2, P // 2 + 1]
    tiled, dd = pad_to_tiles(jnp.asarray(sums), 8)
    want = unpad_flat(j_shamir_rec(tiled, 1, cfg_j, points=points,
                                   block_rows=8, forced=mode), dd)
    got = shamir_reconstruct(torch.from_numpy(sums.astype(np.int64)), 1,
                             cfg_t, points=points)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if mode == "ref":
        eager = cfg_j.decode_mean(j_shamir.reconstruct(sums, points), 7)
        got7 = shamir_reconstruct(torch.from_numpy(sums.astype(np.int64)),
                                  7, cfg_t, points=points)
        np.testing.assert_array_equal(_bits(got7), _bits(eager))


def test_cpu_tensors_take_the_plain_version_without_launching():
    dispatch.reset_launches()
    x = torch.from_numpy(_flats(2, 64))
    keys = _t_keys(_keys(2))
    shares = share_gen_batch(x, 3, keys, TFP())
    reconstruct(shares.sum(0) & 0xFFFFFFFF, 2, TFP())
    fshares = shamir_share_batch(x, 3, keys, TFP(algebra="field"))
    shamir_reconstruct(fshares.sum(0) % P, 2, TFP(algebra="field"))
    verify_shares(fshares[0], torch.ones((64, 1, 2), dtype=torch.int64),
                  (1, 2, 3))
    share_gen(x[0], 3, 5, 6, TFP(), hi_base=64)
    shamir_share(x[0], 3, 5, 6, TFP(algebra="field"), hi_base=64)
    q = x[:, :32].reshape(1, 2, 2, 16)
    flash_attention(q, q, q)
    decode_attention(q[:, :, 0], q, q, kv_len=1)
    xs = x[:1, :32].reshape(1, 2, 16)
    ssm_scan(xs, xs.abs(), xs[..., :4], xs[..., 4:8], -torch.ones(16, 4))
    lru_scan(xs.abs(), xs)
    assert set(dispatch.launches) == {
        "repro_share_gen_batch", "repro_shamir_share_batch",
        "repro_reconstruct", "repro_shamir_reconstruct",
        "repro_verify_shares", "repro_share_gen", "repro_shamir_share",
        "repro_flash_attention", "repro_decode_attention",
        "repro_ssm_scan", "repro_lru_scan"}
    assert all(v == 0 for v in dispatch.launches.values())


@pytest.mark.parametrize("d,offset,ok", [(8, 0, True), (8, 4, True),
                                         (8, 1, False), (7, 1, True)])
def test_share_kernel_inputs_must_be_aligned_for_quad_loads(d, offset, ok):
    # rows of D % 4 == 0 are read 16 bytes at a time on the card: a
    # contiguous view that starts off a 16-byte boundary is refused
    # before any launch; a ragged D is read element by element
    from repro_torch.kernels.share_gen.ops import check_batch_inputs
    base = torch.zeros(2 * d + 8, dtype=torch.float32)
    flats = base[offset:offset + 2 * d].view(2, d)
    assert flats.is_contiguous()
    keys = torch.zeros((2, 2), dtype=torch.int32)
    if ok:
        check_batch_inputs(flats, 3, keys, "share_gen_batch")
    else:
        with pytest.raises(ValueError, match="16-byte boundary"):
            check_batch_inputs(flats, 3, keys, "share_gen_batch")


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty((2, 8), device="meta")
    keys = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        share_gen_batch(x, 3, keys, TFP())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        reconstruct(torch.empty((3, 8), dtype=torch.int32, device="meta"), 1,
                    TFP())
