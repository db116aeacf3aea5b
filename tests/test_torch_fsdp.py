"""The port's MPC-FSDP train step, checkpoints and LR schedules against
the JAX package's.

* The layout rule: every leaf's party dim (``launch.sharding``) against
  the reference's ``param_spec`` and ``_party_dim_tree`` on an (n, 1)
  mesh, for each family's configs at full size (shapes only), and
  ``needs_fsdp`` with its ``hbm_bytes`` argument.
* ``secure_reduce_scatter_dim``: the reference under ``shard_map`` on 4
  forced host devices (one subprocess), the port on 4 ``gloo`` CPU ranks,
  the same numpy cotangents; each party's shard bit for bit, at a leaf
  whose slice is a multiple of 1,024 elements (the share kernels' path)
  and at one that takes the fallback (a whole secure sum), along dim 0
  and dim 1, for a layer index and for ``gidx = -1``.  The same ranks run
  one MPC-FSDP step of the dense smoke config (with ``remat``, so the
  gathers are recomputed in backward): the gathered parameters equal on
  every rank, and within 1e-6 of the replicated layout's step on the
  same ranks (the reference's own test holds 1e-3; the port aggregates
  the same ring sums, and only the clip's norm sums in another order).
* One MPC-FSDP step of the dense smoke config at a world of one against
  the reference's ``make_train_step(fsdp=True)`` on ``make_host_mesh(1,
  1)``: the loss to 1e-5 relative, each parameter's update to 1e-6
  absolute (the tolerances of ``tests/test_torch_train.py``); the same
  with the parameters gathered in bf16 (``gather_dtype``) on both sides.
* One MPC-FSDP step of each family's smoke config (dense, SSM, hybrid,
  and both MoE configs) bit for bit equal to the port's replicated step:
  at one party both compute decode(encode(g)).  Both of the
  reduce-scatter's paths run.
* The reference's refusals: FSDP with enc-dec, with ``local_steps > 1``
  and with ``compress_topk``; the trainer's ``--tp`` above 1 and
  ``--production-mesh`` name a ROADMAP item.
* Checkpoints: each package restores the other's, in the reference's
  layout; a resume is bit-identical to the straight run, residuals
  included; a crashed save is ignored and ``keep`` prunes.
* ``warmup_cosine`` and ``inverse_sqrt`` to 2^-22 relative plus
  2^-22 of the peak rate absolute: ``cos`` and ``sqrt`` come from
  another library (an ulp of 1 apart), and ``1 + cos`` near ``cos = -1``
  turns that into an absolute error of the output.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.launch import sharding as j_sharding
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import _party_dim_tree
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.steps import place
from repro.models import transformer as j_transformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import schedule as j_schedule
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data import lm_batch
from repro_torch.launch import fsdp, sharding, steps, train
from repro_torch.models import transformer
from repro_torch.optim import (AdamWConfig, adamw_init, inverse_sqrt,
                               warmup_cosine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PARTIES, SEED, M = 4, 7, 3
QUANTUM = 2.0 ** -16
ARCHS = ["qwen1.5-0.5b", "tinyllama-1.1b", "falcon-mamba-7b",
         "recurrentgemma-9b", "qwen3-moe-235b-a22b", "grok-1-314b"]
#: (shape, dim, gidx, path): slices of 1,024 (the kernel path) and of 768
#: elements (the fallback) per party
RS_CASES = [((64, 64), 0, 3, "['b0_attn']/['attn']/['wq']"),
            ((32, 128), 1, -1, "['embed']/['table']"),
            ((48, 64), 1, 0, "['b0_attn']/['mlp']/['w_up']"),
            ((64, 48), 0, -1, "['lm_head']/['w']")]


def _tag(path: str) -> int:
    return zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF


def _mesh(n: int):
    """The reference's (n, 1) mesh as its layout rule reads it."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": n, "model": 1})


@pytest.mark.parametrize("arch", ARCHS)
def test_party_dims_match_reference(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    shapes = {p: tuple(leaf.shape) for p, leaf in flatten_with_path(
        transformer.init(cfg, device="meta").params())}
    abstract = j_transformer.abstract_params(j_cfg)
    group_abs = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct(l.shape[1:], l.dtype),
        abstract["layers"])
    for n in (1, 4, 6):
        dims = fsdp.party_dims(shapes, n)
        for path, shape in shapes.items():
            spec = j_sharding.param_spec(path_str(path), shape, j_cfg,
                                         _mesh(n), fsdp=True)
            want = next((i for i, e in enumerate(spec) if e == "data"),
                        None)
            assert dims[path] == want, (path, n)
        group = dict(flatten_with_path(_party_dim_tree(
            group_abs, j_cfg, _mesh(n), stacked=True)))
        for path, dim in dims.items():
            if path[0] == "layers":
                assert group[path[1:]] == (None if dim is None
                                           else dim - 1), (path, n)


@pytest.mark.parametrize("arch", ARCHS + ["llama3.2-1b"])
def test_needs_fsdp_matches_reference(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    for hbm in (16e9, 80e9, 200e9):
        assert sharding.needs_fsdp(cfg, hbm_bytes=hbm) == \
            j_sharding.needs_fsdp(j_cfg, _mesh(1), hbm_bytes=hbm)
    assert sharding.needs_fsdp(cfg) == j_sharding.needs_fsdp(j_cfg, _mesh(1))
    # the trainer's default resolves to MPC-FSDP as the reference's does
    step = steps.make_train_step(cfg, device="cpu")
    assert step.fsdp == j_sharding.needs_fsdp(j_cfg, _mesh(1))


# ---------------------------------------------------------------------------
# four parties: the reference under shard_map, the port over gloo
# ---------------------------------------------------------------------------

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import MeshCapabilityError, make_mesh, set_mesh, shard_map
from repro.launch.steps import secure_reduce_scatter_dim
out, cases, seed, m = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
grads = dict(np.load(out + "/grads.npz"))
n = 4
try:
    mesh = make_mesh((n,), ('data',))
except MeshCapabilityError as e:
    print("COMPAT-SKIP:", e)
    raise SystemExit(0)
res = {}
for i, (shape, dim, gidx, tag) in enumerate(cases):
    f = lambda x: secure_reduce_scatter_dim(
        x[0], dim, ('data',), m=m, seed=seed, tag=tag,
        gidx=jnp.int32(gidx), tp_axis=None)[None]
    g = shard_map(f, mesh=mesh, in_specs=P('data'), out_specs=P('data'),
                  axis_names={'data'}, check_vma=False)
    with set_mesh(mesh):
        res[f"case{i}"] = np.asarray(jax.jit(g)(jnp.asarray(grads[f"case{i}"])))
np.savez(out + "/reference.npz", **res)
print("REFERENCE OK")
"""

RANK = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out, cases, seed, m = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    eval(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data import lm_batch
from repro_torch.launch.fsdp import secure_reduce_scatter_dim
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
grads = dict(np.load(out + "/grads.npz"))
res = {}
for i, (shape, dim, gidx, tag) in enumerate(cases):
    g = torch.from_numpy(grads[f"case{i}"][rank])
    res[f"case{i}"] = secure_reduce_scatter_dim(
        g, dim, m=m, seed=seed, tag=tag, gidx=gidx).numpy()
cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True), remat=True)
toks, labels = lm_batch(cfg.vocab, 8, 16, seed=0, party=0, step=0)
for layout in ("fsdp", "replicated"):
    step = make_train_step(cfg, fsdp=layout == "fsdp", device="cpu")
    model = transformer.init(cfg, seed=0, device="cpu")
    if step.fsdp:
        model = step.shard_model(model)
    opt = adamw_init(model.params())
    model, opt, loss = step(model, opt, 0, {"tokens": toks, "labels": labels})
    res[f"{layout}_loss"] = np.float32(loss)
    for p, leaf in flatten_with_path(step.full_params(model.params())):
        res[f"{layout}:{path_str(p)}"] = leaf.detach().numpy()
    if step.fsdp:
        res["fsdp_shard_shapes"] = np.array(
            [tuple(leaf.shape) == tuple(full.shape) for (_, leaf), (_, full)
             in zip(flatten_with_path(model.params()),
                    flatten_with_path(step.full_params(model.params())))])
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
    out = tmp_path_factory.mktemp("fsdp")
    rng = np.random.RandomState(11)
    cases = [(shape, dim, gidx, _tag(path))
             for shape, dim, gidx, path in RS_CASES]
    np.savez(out / "grads.npz", **{
        f"case{i}": (rng.randn(N_PARTIES, *shape) * 0.3).astype(np.float32)
        for i, (shape, _, _, _) in enumerate(cases)})
    args = [repr(cases), str(SEED), str(M)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{N_PARTIES}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(out), *args],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    env_t = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(N_PARTIES), port, str(out),
         *args], env=env_t, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(N_PARTIES)]
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


@pytest.mark.parametrize("case", range(len(RS_CASES)))
def test_secure_reduce_scatter_matches_reference(runs, case):
    reference, ranks = runs
    shape, dim, _, _ = RS_CASES[case]
    per = shape[0] * shape[1] // N_PARTIES
    want = reference[f"case{case}"]
    for rank, got in enumerate(ranks):
        shard = got[f"case{case}"]
        assert shard.shape == want[rank].shape
        assert shard.shape[dim] == shape[dim] // N_PARTIES
        np.testing.assert_array_equal(shard.view(np.int32),
                                      want[rank].view(np.int32))
    # cases 0 and 1 take the share kernels' path, 2 and 3 the fallback
    assert (per % fsdp.TILE == 0) == (case in (0, 1))


def test_four_ranks_train_fsdp_to_identical_parameters(runs):
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith("fsdp:")]
    assert keys and not ranks[0]["fsdp_shard_shapes"].all()
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
        assert r["fsdp_loss"] == ranks[0]["fsdp_loss"]
    np.testing.assert_allclose(ranks[0]["fsdp_loss"],
                               ranks[0]["replicated_loss"], rtol=1e-6)
    for k in keys:
        np.testing.assert_allclose(
            ranks[0][k], ranks[0]["replicated:" + k.split(":", 1)[1]],
            rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# one party
# ---------------------------------------------------------------------------

def _perturbed(j_cfg):
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {"/".join(str(p) for p in path): np.asarray(leaf)
              + rng.randn(*leaf.shape).astype(np.float32) * 0.05
              for path, leaf in flat}
    tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    return arrays, tree


def _one_party_step_against_reference(gather_dtype):
    """One MPC-FSDP step of the dense smoke config at a world of one,
    the port's against the reference's, the parameters gathered in
    ``gather_dtype`` (``None``: float32) on both sides."""
    j_cfg = dataclasses.replace(j_get_config("qwen1.5-0.5b", smoke=True),
                                compute_dtype="float32")
    t_cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                                compute_dtype="float32")
    arrays, tree = _perturbed(j_cfg)
    toks, labels = lm_batch(256, 8, 16, seed=0, party=0, step=0)
    j_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    mesh = make_host_mesh(1, 1)
    wrap, _, _ = j_make_train_step(
        j_cfg, mesh, seed=0, fsdp=True, donate=False,
        opt=JAdamWConfig(lr=3e-4),
        gather_dtype=None if gather_dtype is None else jnp.bfloat16)
    step, sh = wrap({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in j_batch.items()})
    params = place(tree, sh["params"])
    with compat.set_mesh(mesh):
        p_j, _, loss_j = step(params, place(j_adamw_init(params), sh["opt"]),
                              jnp.int32(0), j_batch)

    t_step = steps.make_train_step(t_cfg, seed=0, fsdp=True,
                                   opt=AdamWConfig(lr=3e-4),
                                   gather_dtype=gather_dtype, device="cpu")
    model = t_step.shard_model(transformer.from_reference(t_cfg, arrays,
                                                          device="cpu"))
    raw = {}
    t_step.observe = lambda g, agg: raw.update(
        (path_str(p), x.numpy()) for p, x in flatten_with_path(agg))
    model, _, loss_t = t_step(model, adamw_init(model.params()), 0,
                              {"tokens": toks, "labels": labels})
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = transformer.to_reference(model)
    exempt = total = 0
    for path, w in jax.tree_util.tree_flatten_with_path(p_j)[0]:
        key = "/".join(str(p) for p in path)
        want = np.asarray(w, np.float64) - arrays[key]
        upd = np.asarray(got[key], np.float64) - arrays[key]
        near0 = np.abs(raw[key]) < QUANTUM
        np.testing.assert_allclose(upd[~near0], want[~near0], rtol=0,
                                   atol=1e-6, err_msg=key)
        exempt += int(near0.sum())
        total += near0.size
    assert exempt < 0.01 * total, (exempt, total)


def test_fsdp_step_matches_reference_at_one_party():
    _one_party_step_against_reference(None)


def test_fsdp_step_with_bf16_gather_matches_reference_at_one_party():
    """``gather_dtype=bfloat16``: both sides gather bf16-rounded
    parameters and carry the cotangent back through bf16."""
    _one_party_step_against_reference(torch.bfloat16)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "qwen3-moe-235b-a22b",
                                  "grok-1-314b"])
def test_fsdp_step_equals_the_replicated_step_at_one_party(arch,
                                                           monkeypatch):
    cfg = get_config(arch, smoke=True)
    paths = {"kernel": 0, "fallback": 0}
    real_share, real_sum = fsdp.share_gen, fsdp.secure_aggregate

    def share(*a, **k):
        paths["kernel"] += 1
        return real_share(*a, **k)

    def whole(*a, **k):
        paths["fallback"] += 1
        return real_sum(*a, **k)
    monkeypatch.setattr(fsdp, "share_gen", share)
    monkeypatch.setattr(fsdp, "secure_aggregate", whole)
    out = {}
    for layout in (False, True):
        step = steps.make_train_step(cfg, fsdp=layout, device="cpu")
        model = transformer.init(cfg, seed=0, device="cpu")
        if layout:
            model = step.shard_model(model)
        opt = adamw_init(model.params())
        for i in range(2):
            toks, labels = lm_batch(cfg.vocab, 4, 16, seed=0, party=0, step=i)
            model, opt, loss = step(model, opt, i,
                                    {"tokens": toks, "labels": labels})
        out[layout] = (float(loss), flatten_with_path(model.params()),
                       flatten_with_path(opt["m"]))
    assert out[True][0] == out[False][0]
    for k in (1, 2):
        for (pa, a), (pb, b) in zip(out[False][k], out[True][k]):
            assert pa == pb
            assert torch.equal(a.detach().view(torch.int32),
                               b.detach().view(torch.int32)), pa
    # at one party every split slice of the dense smoke config is a
    # multiple of 1,024 elements; the SSM, hybrid and MoE ones hold others
    # (a MoE router [64, 4] among them)
    assert paths["kernel"] > 0, paths
    assert (paths["fallback"] > 0) == (arch != "qwen1.5-0.5b"), paths


def test_fsdp_refusals_are_the_references():
    smoke = get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        steps.make_train_step(dataclasses.replace(smoke, enc_dec=True),
                              fsdp=True, device="cpu")
    with pytest.raises(NotImplementedError, match="local_steps requires"):
        steps.make_train_step(smoke, fsdp=True, local_steps=2, device="cpu")
    with pytest.raises(NotImplementedError, match="compress_topk requires"):
        steps.make_train_step(smoke, fsdp=True, compress_topk=0.1,
                              device="cpu")
    with pytest.raises(ValueError, match=r"must be in \[0, 1\]"):
        steps.make_train_step(smoke, compress_topk=1.5, device="cpu")
    for argv, item in ((["--tp", "2"], "item 11"),
                       (["--production-mesh"], "item 11")):
        with pytest.raises(NotImplementedError, match=f"TPU|{item}") as e:
            train.run(train.parse_args(["--smoke", "--device", "cpu",
                                        *argv]))
        assert "ROADMAP queue 1, item 11" in str(e.value)


# ---------------------------------------------------------------------------
# checkpoints and schedules
# ---------------------------------------------------------------------------

def test_checkpoints_cross_between_the_packages(tmp_path):
    j_cfg = j_get_config("qwen1.5-0.5b", smoke=True)
    arrays, tree = _perturbed(j_cfg)
    t_cfg = get_config("qwen1.5-0.5b", smoke=True)
    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    params = model.params()
    opt = adamw_init(params)
    opt["ef"] = steps.init_error_feedback(params, 2)
    for _, leaf in flatten_with_path(opt):
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    Checkpointer(str(tmp_path / "port")).save(3, {"params": params,
                                                 "opt": opt})
    j_opt = dict(j_adamw_init(tree))
    j_opt["ef"] = jax.tree.map(lambda l: jnp.zeros((2,) + l.shape), tree)
    got, step = JCheckpointer(str(tmp_path / "port")).restore(
        {"params": tree, "opt": j_opt})
    assert step == 3
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "/".join(str(p) for p in path)
        want = dict((path_str(p), x.detach().numpy()) for p, x in
                    flatten_with_path({"params": params, "opt": opt}))[key]
        np.testing.assert_array_equal(np.asarray(leaf), want)
    # and back: the reference's checkpoint into the port's tree
    JCheckpointer(str(tmp_path / "ref")).save(5, got)
    back, step = Checkpointer(str(tmp_path / "ref")).restore(
        {"params": params, "opt": opt})
    assert step == 5
    for (pa, a), (pb, b) in zip(flatten_with_path(back), flatten_with_path(
            {"params": params, "opt": opt})):
        assert pa == pb and isinstance(a, torch.Tensor)
        assert torch.equal(a, b.detach())


def test_resume_is_bit_identical_and_saves_are_atomic(tmp_path):
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--compress-topk", "0.05",
            "--ckpt-every", "1"]
    straight = train.run(train.parse_args(base + ["--steps", "4"]))
    ck = str(tmp_path / "ck")
    first = train.run(train.parse_args(base + ["--steps", "2", "--ckpt-dir",
                                                ck]))
    # a crashed save (no manifest) is ignored
    os.makedirs(os.path.join(ck, "step_00000009"))
    resumed = train.run(train.parse_args(base + ["--steps", "4",
                                                 "--ckpt-dir", ck]))
    assert resumed["start"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for key in ("params", "opt"):
        want = straight["model"].params() if key == "params" \
            else straight["opt_state"]
        got = resumed["model"].params() if key == "params" \
            else resumed["opt_state"]
        for (pa, a), (pb, b) in zip(flatten_with_path(got),
                                    flatten_with_path(want)):
            assert pa == pb and torch.equal(a.detach(), b.detach()), pa
    assert "ef" in resumed["opt_state"]
    # keep=3 pruned the oldest of steps 1, 2, 3 (and the latest is 3)
    assert Checkpointer(ck).list_steps() == [1, 2, 3]


def test_schedules_match_reference():
    steps_ = np.arange(0, 140, dtype=np.int32)
    for kw in (dict(peak_lr=3e-4, warmup=10, total=100),
               dict(peak_lr=1e-2, warmup=0, total=50, floor=0.0),
               dict(peak_lr=2.5e-3, warmup=7, total=7, floor=0.2)):
        for s in steps_:
            got = float(warmup_cosine(int(s), **kw))
            want = float(j_schedule.warmup_cosine(jnp.int32(s), **kw))
            np.testing.assert_allclose(got, want, rtol=2 ** -22,
                                       atol=kw["peak_lr"] * 2 ** -22,
                                       err_msg=str((kw, s)))
    for kw in (dict(peak_lr=3e-4, warmup=10), dict(peak_lr=1e-3, warmup=1)):
        got = inverse_sqrt(torch.from_numpy(steps_), **kw).numpy()
        want = np.asarray(j_schedule.inverse_sqrt(jnp.asarray(steps_), **kw))
        np.testing.assert_allclose(got, want, rtol=2 ** -22,
                                   atol=kw["peak_lr"] * 2 ** -22)
