"""The port's model, optimizer and secure train step against the JAX
package's, with the reference's weights carried across.

The smoke config of qwen1.5-0.5b (2 layers, d_model 64, vocab 256) is
built in the reference, its parameters are perturbed with numpy noise
(so the zero biases and unit norm scales carry gradients of their own)
and loaded into the port by ``transformer.from_reference``.

Tolerances and why:

* float32 compute: the loss to 1e-5 relative and every gradient leaf to
  1e-4 of its max-abs — the same operations, with sums in another order
  and ``exp``/``cos`` from another library;
* bf16 compute (the config's own): the loss to 1e-3 relative and every
  gradient leaf to 5e-2 of its max-abs — bf16 keeps 8 bits (a relative
  step of 2^-8 = 3.9e-3), and the two frameworks round to bf16 at other
  places inside the fused products (observed: 4.4e-6 on the loss, 2.4e-2
  on the worst leaf, a bias whose gradient sums 64 bf16 products);
* ``secure_aggregate_tree``: bit for bit (integer sums, the same decode);
* ``adamw_update`` on the same aggregated gradients: 1e-6 absolute;
* one full step (and one of two local iterations): the loss to 1e-5
  relative, and each parameter's update ``p_after - p_before`` to 1e-6
  absolute against the reference's update.  Adam's first step moves a
  weight by about ``lr·sign(g)`` with ``lr`` = 3e-4, so a skipped or
  reversed update misses by ``lr`` or ``2·lr``.  Exempt are only the
  elements that part where the gradient (pseudo-gradient) is nonzero and
  lies within one fixed-point quantum (2^-16) of 0: one side may round
  it to 0 and the other to one quantum, and then it moves by ``lr`` on
  one side only.  Those must be under 1 % of the elements; the near-0
  elements that do not part are held like the rest (the hybrid has 2 %
  of its gradient there), and a gradient of exactly 0 (an embedding row
  no token reads) is 0 on both sides, and is held.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as j_get_config
from repro.fl.spmd import secure_aggregate_tree as j_secure_aggregate_tree
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.steps import place
from repro.models import transformer as j_transformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str, unflatten
from repro_torch.data import lm_batch
from repro_torch.fl.spmd import secure_aggregate_tree
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
LR = 3e-4


def _configs(compute_dtype="float32", arch=ARCH):
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True),
                                compute_dtype=compute_dtype)
    t_cfg = dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=compute_dtype)
    return j_cfg, t_cfg


def _reference_weights(arch=ARCH):
    """The reference's perturbed smoke parameters: ``(arrays by path,
    jax tree)``."""
    j_cfg, _ = _configs(arch=arch)
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {}
    for path, leaf in flat:
        a = np.asarray(leaf)
        arrays["/".join(str(p) for p in path)] = (
            a + rng.randn(*a.shape).astype(np.float32) * 0.05)
    tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    return arrays, tree


@pytest.fixture(scope="module")
def weights():
    return _reference_weights()


def _batch(b=8, s=16, step=0):
    toks, labels = lm_batch(256, b, s, seed=0, party=0, step=step)
    return toks, labels


QUANTUM = 2.0 ** -16  # the fixed-point codec's step (frac_bits 16)


def _assert_updates_match(before, after_j, after_t, grads):
    """Each leaf's update held to the reference's to 1e-6, apart from
    elements that part where the gradient is nonzero and within one
    quantum of 0 (a small fraction); ``before``/``grads`` keyed by the
    reference's leaf paths."""
    exempt = total = 0
    for path, w in jax.tree_util.tree_flatten_with_path(after_j)[0]:
        key = "/".join(str(p) for p in path)
        want = np.asarray(w, np.float64) - before[key]
        got = np.asarray(after_t[key], np.float64) - before[key]
        # an exact 0 (an embedding row no token of the batch reads)
        # encodes to 0 on both sides and is held like the rest
        near0 = (np.abs(grads[key]) < QUANTUM) & (grads[key] != 0)
        parted = near0 & (np.abs(got - want) > 1e-6)
        np.testing.assert_allclose(got[~parted], want[~parted], rtol=0,
                                   atol=1e-6, err_msg=key)
        exempt += int(parted.sum())
        total += near0.size
    assert exempt < 0.01 * total, (exempt, total)


def _port_loss_and_grads(t_cfg, arrays, toks, labels):
    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    params = model.params()
    flat = flatten_with_path(params)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    loss = transformer.loss_fn(params, batch, t_cfg)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
    return loss.item(), {path_str(p): g.numpy() for (p, _), g in
                         zip(flat, grads)}


@pytest.mark.parametrize("arch,compute_dtype,loss_rtol,grad_tol", [
    (ARCH, "float32", 1e-5, 1e-4), (ARCH, "bfloat16", 1e-3, 5e-2),
    # grouped KV heads, no QKV bias, untied head
    ("tinyllama-1.1b", "float32", 1e-5, 1e-4),
    # the hybrid: rec and local-attention layers, a tail, the chunked
    # RG-LRU scan under autograd on both sides
    ("recurrentgemma-9b", "float32", 1e-5, 1e-4)])
def test_loss_and_gradients_match_reference(weights, arch, compute_dtype,
                                            loss_rtol, grad_tol):
    arrays, tree = weights if arch == ARCH else _reference_weights(arch)
    j_cfg, t_cfg = _configs(compute_dtype, arch)
    toks, labels = _batch(4)
    j_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: j_transformer.loss_fn(p, j_batch, j_cfg)))(tree)
    loss_t, grads_t = _port_loss_and_grads(t_cfg, arrays, toks, labels)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=loss_rtol)
    j_flat = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(j_flat) == len(grads_t)
    for path, g in j_flat:
        want = np.asarray(g, dtype=np.float32)
        got = grads_t["/".join(str(p) for p in path)]
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= grad_tol * scale, path


@pytest.mark.parametrize("impl", ["dense", "xla_chunked"])
def test_attention_matches_reference(impl):
    """Both training paths, with grouped KV heads and causal masking
    aligned at the last key; 1e-6 absolute on outputs of magnitude ~1."""
    from repro.models.attention import attention as j_attention
    from repro_torch.models.attention import attention
    j_cfg, t_cfg = _configs(arch="tinyllama-1.1b")
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 32, 16).astype(np.float32)
    k, v = (rng.randn(2, 2, 64, 16).astype(np.float32) for _ in range(2))
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), j_cfg,
                       impl=impl, block_k=16)
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), t_cfg,
                    impl=impl, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_remat_changes_no_number(weights):
    arrays, _ = weights
    _, t_cfg = _configs()
    toks, labels = _batch(4)
    loss0, g0 = _port_loss_and_grads(t_cfg, arrays, toks, labels)
    loss1, g1 = _port_loss_and_grads(dataclasses.replace(t_cfg, remat=True),
                                     arrays, toks, labels)
    assert loss0 == loss1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])


def _grad_tree(tree, seed=1):
    """Gradient-like numpy values shaped like the parameters, with a few
    large and tiny elements."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        g = (rng.randn(*leaf.shape) * 1e-2).astype(np.float32)
        g.reshape(-1)[:2] = [3.5, 1e-7]
        out["/".join(str(p) for p in path)] = g
    return out, treedef, [p for p, _ in flat]


def test_secure_aggregate_tree_matches_reference(weights):
    # the train step's scheme; tests/test_torch_spmd.py covers Shamir
    scheme = "additive"
    _, tree = weights
    grads, treedef, paths = _grad_tree(tree)
    j_tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(grads["/".join(str(p) for p in path)])
                  for path in paths])
    # a world of one as a vmap over a party axis of size 1 (the
    # reference's collectives and axis_index work under vmap): eager, so
    # the reference's jitted share and decode functions compile per
    # padded leaf length (two lengths here) instead of as one program of
    # all 14 leaves
    want = jax.vmap(
        lambda t: j_secure_aggregate_tree(t, scheme=scheme, m=3,
                                          party_axes=("data",), seed=0,
                                          round_index=3, mode="psum"),
        axis_name="data")(jax.tree.map(lambda a: a[None], j_tree))
    want = jax.tree.map(lambda a: a[0], want)
    t_tree = unflatten([tuple(k.strip("[]'") for k in p.split("/"))
                        for p in grads],
                       [torch.from_numpy(g) for g in grads.values()])
    got = secure_aggregate_tree(t_tree, scheme=scheme, m=3, seed=0,
                                round_index=3, mode="psum")
    got_flat = {path_str(p): g for p, g in flatten_with_path(got)}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_array_equal(
            got_flat["/".join(str(p) for p in path)].numpy().view(np.int32),
            np.asarray(w).view(np.int32))


def test_adamw_update_matches_reference(weights):
    arrays, tree = weights
    grads, treedef, paths = _grad_tree(tree, seed=2)
    j_grads = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(grads["/".join(str(p) for p in path)])
                  for path in paths])
    j_opt = j_adamw_init(tree)
    # a second step, so the moments and the bias corrections matter
    p1, o1 = jax.jit(j_adamw_update, static_argnums=4)(
        j_grads, j_opt, tree, jnp.int32(0), JAdamWConfig())
    p2, _ = jax.jit(j_adamw_update, static_argnums=4)(
        j_grads, o1, p1, jnp.int32(1), JAdamWConfig())
    _, t_cfg = _configs()
    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    params = model.params()
    t_grads = unflatten([p for p, _ in flatten_with_path(params)],
                        [torch.from_numpy(grads[path_str(p)]) for p, _ in
                         flatten_with_path(params)])
    opt = adamw_init(params)
    adamw_update(t_grads, opt, params, 0, AdamWConfig())
    adamw_update(t_grads, opt, params, 1, AdamWConfig())
    got = transformer.to_reference(model)
    for path, w in jax.tree_util.tree_flatten_with_path(p2)[0]:
        np.testing.assert_allclose(got["/".join(str(p) for p in path)],
                                   np.asarray(w), rtol=0, atol=1e-6)


def _both_steps(weights, arch=ARCH, **kw):
    """One two_phase additive step of the reference (a (1, 1) mesh) and
    of the port (a world of one) from the same weights and batch, of
    ``arch``'s smoke config in float32.  Returns ``(loss_j, params_j,
    loss_t, params_t, grads_t)`` with the port's per-party gradient (or
    pseudo-gradient) tree by leaf path."""
    arrays, tree = weights
    j_cfg, t_cfg = _configs(arch=arch)
    toks, labels = _batch()
    j_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    mesh = make_host_mesh(1, 1)
    wrap, _, _ = j_make_train_step(j_cfg, mesh, protocol="two_phase",
                                   scheme="additive", m=3, seed=0,
                                   fsdp=False, donate=False,
                                   opt=JAdamWConfig(lr=LR), **kw)
    step, sh = wrap({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in j_batch.items()})
    params = place(tree, sh["params"])
    opt = place(j_adamw_init(params), sh["opt"])
    with compat.set_mesh(mesh):
        p_j, _, loss_j = step(params, opt, jnp.int32(0), j_batch)

    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    t_step = make_train_step(t_cfg, protocol="two_phase", scheme="additive",
                             m=3, seed=0, opt=AdamWConfig(lr=LR),
                             device="cpu", **kw)
    seen = {}
    t_step.observe = lambda g, agg: seen.update(
        (path_str(p), leaf.numpy()) for p, leaf in flatten_with_path(g))
    model, _, loss_t = t_step(model, adamw_init(model.params()), 0,
                              {"tokens": toks, "labels": labels})
    return loss_j, p_j, loss_t, transformer.to_reference(model), seen


def test_one_train_step_matches_reference(weights):
    loss_j, p_j, loss_t, p_t, grads = _both_steps(weights)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_updates_match(weights[0], p_j, p_t, grads)


def test_one_hybrid_train_step_matches_reference():
    """recurrentgemma-9b's smoke config (one rec, rec, attn group and a
    rec tail, window 8): one replicated secure step against the
    reference's, the RG-LRU trained through the chunked scan on both
    sides."""
    weights = _reference_weights("recurrentgemma-9b")
    loss_j, p_j, loss_t, p_t, grads = _both_steps(weights,
                                                  arch="recurrentgemma-9b")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_updates_match(weights[0], p_j, p_t, grads)


def test_trainer_cli_runs_each_protocol_on_the_cpu():
    losses = {}
    for argv in (["--protocol", "plain"], ["--scheme", "shamir"],
                 ["--protocol", "p2p"], ["--agg-mode", "reduce_scatter"]):
        out = train.run(train.parse_args(
            ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4",
             "--seq", "16", "--device", "cpu", *argv]))
        assert len(out["losses"]) == 2
        assert all(np.isfinite(out["losses"]))
        losses[argv[1]] = out["losses"]
    # the first loss is the same model on the same batch
    assert len({v[0] for v in losses.values()}) == 1


def test_local_steps_train_with_a_pseudo_gradient(weights):
    """Two local SGD iterations, then the pseudo-gradient
    ``(params - local)/inner_lr`` aggregated and fed to AdamW."""
    loss_j, p_j, loss_t, p_t, pseudo = _both_steps(weights, local_steps=2,
                                                   inner_lr=0.02)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_updates_match(weights[0], p_j, p_t, pseudo)


RANK = r"""
import hashlib, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
cfg = get_config("qwen1.5-0.5b", smoke=True)
model = transformer.init(cfg, seed=0, device="cpu")
opt = adamw_init(model.params())
losses = {}
for scheme in ("additive", "shamir"):
    step = make_train_step(cfg, scheme=scheme, device="cpu")
    for i in range(2):
        toks, labels = lm_batch(cfg.vocab, 8, 16, seed=0, party=0, step=i)
        model, opt, loss = step(model, opt, i,
                                {"tokens": toks, "labels": labels})
        losses[f"{scheme}{i}"] = float(loss)
np.savez(f"{out}/rank{rank}.npz", losses=np.array(list(losses.values())),
         **transformer.to_reference(model))
dist.destroy_process_group()
"""


def test_four_gloo_ranks_train_to_identical_parameters(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "4", port,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    for proc in procs:
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(r[k], v)
    assert np.isfinite(ranks[0]["losses"]).all()
