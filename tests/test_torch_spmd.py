"""The port's SPMD secure aggregation against the JAX package's.

* The single-party share kernels' plain versions (what a wrapper runs
  for a CPU tensor) against the reference's ``share_gen`` and
  ``shamir_share`` (``use_ref=True``, ``layout="tiled"``), bit for bit,
  at a ragged D, ``hi_base`` 0 and 192, and m in {1, 3, 5}.
* ``secure_aggregate`` in every mode: the reference under ``shard_map``
  on 4 forced host devices (one subprocess), the port on 4 ``gloo`` CPU
  ranks (one launch of 4 processes), the same numpy inputs.  Secure
  means are integer sums decoded alike, so they must be identical;
  ``plain`` is a float32 sum in another order (gloo's ring, XLA's
  psum), held to 4 ulp of the mean's magnitude.  Each party's additive
  shares equal the reference's ``_share_dynamic`` for its
  ``hi_base = pid·64``; each party's Shamir shares equal the reference's
  plain ``shamir_share`` under the same party keys (the reference gives
  every party the round key; the port keys each party, ROADMAP queue 3).
* ``field_psum`` on limb-overflow inputs, ``elect_committee_spmd``,
  ``secure_aggregate_tree`` with chunked leaves, ``leaf_seed_tag`` of
  the 14 qwen1.5-0.5b leaves, and the decode of n > 1 parties (the
  reference's jitted decode is a reciprocal multiply).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.fixed_point import FixedPointConfig as JFP
from repro.fl.spmd import leaf_seed_tag as j_leaf_seed_tag
from repro.kernels.reconstruct import reconstruct as j_reconstruct
from repro.kernels.shamir import shamir_reconstruct as j_shamir_rec
from repro.kernels.shamir import shamir_share as j_shamir_share
from repro.kernels.share_gen import share_gen as j_share_gen
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.core.fixed_point import FixedPointConfig as TFP
from repro_torch.core.tree import flatten_with_path
from repro_torch.fl import spmd
from repro_torch.kernels.reconstruct import reconstruct
from repro_torch.kernels.shamir import shamir_reconstruct, shamir_share
from repro_torch.kernels.share_gen import share_gen
from repro_torch.models import transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 0x7FFFFFFF
N_PARTIES, D, SEED, ROUND = 4, 2000, 5, 1
CASES = [("additive", "psum"), ("additive", "reduce_scatter"),
         ("additive", "p2p"), ("additive", "plain"), ("shamir", "psum")]


def _flats():
    x = (np.random.RandomState(0).randn(N_PARTIES, D) * 3).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, 0.5 / 65536]
    return x


def _limb_inputs():
    """F_p words whose 16-bit limbs sum past 2^16 and 2^15 over 4
    parties, edge values first."""
    x = np.random.RandomState(1).randint(0, P, size=(N_PARTIES, 64))
    x[:, 0] = P - 1
    x[:, 1] = 0x7FFEFFFF
    x[:, 2] = 0xFFFF
    x[:, 3] = 0
    return x.astype(np.int64)


# ---------------------------------------------------------------------------
# the reference, under shard_map on 4 forced host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import MeshCapabilityError, make_mesh, set_mesh, shard_map
from repro.core import philox
from repro.core.fixed_point import DEFAULT_FIELD, DEFAULT_RING
from repro.fl.spmd import (_pad_len, _share_dynamic, elect_committee_spmd,
                           field_psum, secure_aggregate,
                           secure_aggregate_tree)
from repro.kernels.shamir import shamir_share
out, cases = sys.argv[1], eval(sys.argv[2])
flats, limbs = np.load(out + "/inputs.npz").values()
n, d = flats.shape
try:
    mesh = make_mesh((n,), ('data',))
except MeshCapabilityError as e:
    print("COMPAT-SKIP:", e)
    raise SystemExit(0)

def smap(f, x):
    g = shard_map(f, mesh=mesh, in_specs=P('data', None),
                  out_specs=P('data', None), axis_names={'data'},
                  check_vma=False)
    with set_mesh(mesh):
        return np.asarray(jax.jit(g)(jnp.asarray(x)))

res = {}
for scheme, mode in cases:
    res[f"mean_{scheme}_{mode}"] = smap(lambda x: secure_aggregate(
        x[0], scheme=scheme, m=3, party_axes=('data',), seed=%(seed)d,
        round_index=%(round)d, mode=mode, block_rows=8)[None], flats)
res["field_psum"] = smap(lambda x: field_psum(
    x[0].astype(jnp.uint32), ('data',))[None], limbs.astype(np.uint32))
res["elect"] = smap(lambda x: elect_committee_spmd(
    n, 3, 10, seed=4, party_axes=('data',))[None], flats)

def tree_mean(x):
    tree = {"a": x[0, :1400].reshape(2, 700), "b": {"c": x[0, 1400:]}}
    out = secure_aggregate_tree(tree, scheme="additive", m=3,
                                party_axes=('data',), seed=9, round_index=2,
                                mode="psum", block_rows=8, chunk_elems=512)
    return jnp.concatenate([out["a"].ravel(), out["b"]["c"]])[None]
res["tree"] = smap(tree_mean, flats)

k0, k1 = philox.derive_key(%(seed)d, %(round)d)
pad = _pad_len(d, 8, n) - d
for pid in range(n):
    flat_p = jnp.pad(jnp.asarray(flats[pid]), (0, pad))
    hi = jnp.uint32(pid * 64)
    sh, _ = _share_dynamic(flat_p, 3, k0, k1, DEFAULT_RING, hi, 8, True)
    res[f"add_shares_{pid}"] = np.asarray(sh).reshape(3, -1)[:, :d]
    k0p = k0 ^ (hi * jnp.uint32(0x9E3779B9))
    k1p = k1 + hi
    sh, _ = shamir_share(flat_p, 3, k0p, k1p, DEFAULT_FIELD, block_rows=8,
                         use_ref=True)
    res[f"shamir_shares_{pid}"] = np.asarray(sh).reshape(3, -1)[:, :d]
np.savez(out + "/reference.npz", **res)
print("REFERENCE OK")
"""

# ---------------------------------------------------------------------------
# the port, one process per party over gloo
# ---------------------------------------------------------------------------

RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out, cases = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], eval(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.core.fixed_point import DEFAULT_FIELD, DEFAULT_RING
from repro_torch.fl import spmd
from repro_torch.kernels.shamir import shamir_share
flats, limbs = np.load(out + "/inputs.npz").values()
flat = torch.from_numpy(flats[rank])
res = {}
for scheme, mode in cases:
    res[f"mean_{scheme}_{mode}"] = spmd.secure_aggregate(
        flat, scheme=scheme, m=3, seed=%(seed)d, round_index=%(round)d,
        mode=mode, block_rows=8).numpy()
res["field_psum"] = spmd.field_psum(torch.from_numpy(limbs[rank])).numpy()
res["elect"] = spmd.elect_committee_spmd(world, 3, 10, seed=4,
                                        device="cpu").numpy()
# the same psum round and election through the transport adapter
from repro_torch.fl import make_transport
tr = make_transport("two_phase", world, backend="spmd", m=3, seed=%(seed)d,
                    block_rows=8, device="cpu")
res["transport_mean"] = tr.aggregate(flat, round_index=%(round)d).numpy()
res["transport_elect"] = make_transport(
    "two_phase", world, backend="spmd", seed=4, device="cpu").elect().numpy()
tree = {"a": flat[:1400].reshape(2, 700), "b": {"c": flat[1400:]}}
t = spmd.secure_aggregate_tree(tree, scheme="additive", m=3, seed=9,
                               round_index=2, mode="psum", block_rows=8,
                               chunk_elems=512)
res["tree"] = torch.cat([t["a"].reshape(-1), t["b"]["c"]]).numpy()
k0, k1 = spmd.round_keys(%(seed)d, %(round)d)
res["add_shares"] = spmd._share_dynamic(flat, 3, k0, k1, DEFAULT_RING,
                                        rank * 64).numpy()
res["shamir_shares"] = shamir_share(
    flat, 3, *spmd.party_keys(k0, k1, rank * 64), DEFAULT_FIELD).numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: ``(reference dict, [rank dicts])``."""
    out = tmp_path_factory.mktemp("spmd")
    np.savez(out / "inputs.npz", _flats(), _limb_inputs())
    fill = {"seed": SEED, "round": ROUND}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{N_PARTIES}")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE % fill, str(out), repr(CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    env_t = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", RANK % fill, str(r), str(N_PARTIES), port,
         str(out), repr(CASES)], env=env_t, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(N_PARTIES)]
    for proc in ranks:
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
    stdout, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err
    for line in stdout.splitlines():
        if line.startswith("COMPAT-SKIP:"):
            reason = line.split(":", 1)[1].strip()
            assert "cannot express the mesh" in reason, reason
            pytest.skip(f"capability: {reason}")
    reference = dict(np.load(out / "reference.npz"))
    return reference, [dict(np.load(out / f"rank{r}.npz"))
                       for r in range(N_PARTIES)]


@pytest.mark.parametrize("scheme,mode", CASES)
def test_secure_aggregate_matches_reference(runs, scheme, mode):
    reference, ranks = runs
    key = f"mean_{scheme}_{mode}"
    for r, got in enumerate(ranks):
        want = reference[key][r]
        assert got[key].shape == want.shape == (D,)
        # every party holds the same mean
        np.testing.assert_array_equal(got[key].view(np.int32),
                                      ranks[0][key].view(np.int32))
        if mode == "plain":
            # float32 sums of 4 terms in another order (and XLA's
            # reciprocal multiply for the / n): within 4 ulp of the
            # largest mean of magnitudes; non-finite elements alike
            mags = np.abs(_flats()).mean(0)
            tol = 4 * np.spacing(mags[np.isfinite(mags)].max())
            np.testing.assert_allclose(got[key], want, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(got[key].view(np.int32),
                                          want.view(np.int32))


def test_party_shares_match_reference(runs):
    reference, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["add_shares"].astype(np.uint32),
                                      reference[f"add_shares_{r}"])
        np.testing.assert_array_equal(got["shamir_shares"].astype(np.uint32),
                                      reference[f"shamir_shares_{r}"])


def test_field_psum_election_and_tree_match_reference(runs):
    reference, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["field_psum"].astype(np.uint32),
                                      reference["field_psum"][r])
        np.testing.assert_array_equal(got["elect"], reference["elect"][r])
        # SPMDTransport runs the same election and psum round
        np.testing.assert_array_equal(got["transport_elect"],
                                      reference["elect"][r])
        np.testing.assert_array_equal(
            got["transport_mean"].view(np.int32),
            reference["mean_additive_psum"][r].view(np.int32))
        np.testing.assert_array_equal(got["tree"].view(np.int32),
                                      reference["tree"][r].view(np.int32))
    # the limb sums overflowed 16 bits, and the fold still gives the
    # field sum
    limbs = _limb_inputs()
    assert (limbs & 0xFFFF).sum(0).max() >= 1 << 16
    np.testing.assert_array_equal(ranks[0]["field_psum"], limbs.sum(0) % P)


@pytest.mark.parametrize("m,hi_base", [(1, 0), (3, 0), (3, 192), (5, 192)])
def test_single_party_share_kernels_match_reference(m, hi_base):
    d = 1001
    x = (np.random.RandomState(m).randn(d) * 20).astype(np.float32)
    x[:5] = [np.nan, np.inf, -np.inf, 0.5 / 65536, 1.5 / 65536]
    k0, k1 = 0x1234567, 0xABCDEF01
    jk = (jnp.uint32(k0), jnp.uint32(k1))
    for j_fn, t_fn, algebra in ((j_share_gen, share_gen, "ring"),
                                (j_shamir_share, shamir_share, "field")):
        tiled, dd = j_fn(jnp.asarray(x), m, *jk, JFP(algebra=algebra),
                         hi_base=hi_base, block_rows=8, use_ref=True,
                         layout="tiled")
        want = np.asarray(tiled).reshape(m, -1)[:, :dd]
        got = t_fn(torch.from_numpy(x), m, k0, k1, TFP(algebra=algebra),
                   hi_base=hi_base)
        assert got.dtype == torch.int64 and tuple(got.shape) == (m, d)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("n", [3, 4, 7])
def test_decode_of_n_parties_is_the_references_reciprocal_multiply(n):
    """The reference's jitted decode at n > 1 multiplies by
    ``f32(1/(scale·n))``; the port passes that factor with n = 1."""
    rng = np.random.RandomState(n)
    sums = rng.randint(0, 2 ** 32, size=(1, 8, 128),
                       dtype=np.uint64).astype(np.uint32)
    fsums = rng.randint(0, P, size=(1, 8, 128)).astype(np.uint32)
    inv = spmd.decode_inv_scale(TFP(), n)
    for j_fn, t_fn, s, algebra in (
            (j_reconstruct, reconstruct, sums, "ring"),
            (j_shamir_rec, shamir_reconstruct, fsums, "field")):
        want = np.asarray(j_fn(jnp.asarray(s), n, JFP(algebra=algebra),
                               use_ref=True)).ravel()
        got = t_fn(torch.from_numpy(s.reshape(1, -1).astype(np.int64)), 1,
                   TFP(algebra=algebra), inv_scale=inv).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        divided = t_fn(torch.from_numpy(s.reshape(1, -1).astype(np.int64)),
                       n, TFP(algebra=algebra)).numpy()
        # a power of two divides exactly; 3 and 7 do not
        assert (divided != want).any() == (n in (3, 7))


def test_leaf_seed_tags_of_qwen_match_reference():
    abstract = j_transformer.abstract_params(j_get_config("qwen1.5-0.5b"))
    j_paths = jax.tree_util.tree_flatten_with_path(abstract)[0]
    model = transformer.init(get_config("qwen1.5-0.5b"), device="meta")
    t_flat = flatten_with_path(model.params())
    assert len(j_paths) == len(t_flat) == 14
    for (jp, jleaf), (tp, tleaf) in zip(j_paths, t_flat):
        assert spmd.leaf_seed_tag(tp) == j_leaf_seed_tag(jp)
        assert tuple(tleaf.shape) == tuple(jleaf.shape)


@pytest.mark.parametrize("cards,local_ranks,want", [
    (8, 8, "nccl"), (8, 4, "nccl"), (1, 4, "gloo"), (0, 1, "gloo")])
def test_backend_rule_holds_this_nodes_ranks_against_its_cards(
        monkeypatch, cards, local_ranks, want):
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.choose_backend(local_ranks, "cuda") == want
    assert mesh.choose_backend(local_ranks, "cpu") == "gloo"


def test_multi_node_torchrun_gives_each_rank_its_own_card(monkeypatch):
    """Two nodes of 8 ranks, 8 cards each: 16 ranks outnumber one node's
    cards, but each rank has a card of its own, so the group is NCCL and
    local rank 3 computes on card 3."""
    from repro_torch.launch import mesh
    joined = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 16)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda: 11)
    for k, v in dict(WORLD_SIZE="16", RANK="11", LOCAL_RANK="3",
                     LOCAL_WORLD_SIZE="8").items():
        monkeypatch.setenv(k, v)
    got = mesh.init_from_env("cuda")
    assert joined == ["nccl"]
    assert got == {"world": 16, "rank": 11, "backend": "nccl",
                   "device": torch.device("cuda", 3)}
