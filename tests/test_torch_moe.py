"""The port's MoE family (qwen3-moe-235b-a22b, grok-1-314b) against the
JAX package's, on the CPU.

* ``moe_apply`` in both ``moe_dispatch`` modes, with drops forced by a
  capacity factor below 1, on a zero input (every router logit tied)
  and with router columns of zeros (exact ties at the top-k boundary):
  the expert choices, the positions in the experts and ``keep`` equal to
  the reference's (read from its ``jax.lax.top_k`` and ``jnp.where``
  calls, run op by op), the outputs within 1e-6;
* ``aux_load_balance_loss`` within 1e-6;
* for both smoke configs, with the reference's weights (perturbed with
  numpy noise) carried across by ``from_reference``: prefill logits and
  the loss, the gradients, 8 decode steps, the greedy serve loop
  (``generate``), a bf16 prefill, one replicated secure train step
  against the reference's ``make_train_step``, and one MPC-FSDP step
  bit for bit equal to the port's replicated step at one party;
* decode over a prompt ending on the prefill's logits, on an input
  where neither drops an assignment (a capacity factor of E/k): prefill
  routes B·S tokens under one capacity and decode B, so with drops the
  two differ by the reference's own semantics;
* the full-size trees of both configs (their ``ARCH``): leaf paths and
  shapes equal to the reference's, through ``jax.eval_shape`` and the
  meta device, so nothing is allocated.

Tolerances and why:

* routing and positions: equal (integers; the same float32 router
  logits up to the matmul's summation order, and no near-tie in these
  inputs);
* ``moe_apply`` and the aux loss in float32: 1e-6 absolute on outputs
  of magnitude ~1 — the same products and sums, the k-way combine summed
  in another order;
* model logits and loss in float32 compute: 1e-4 absolute, and the
  gradients to 1e-4 of each leaf's max-abs (``PERF.md`` §2, as for the
  dense and hybrid families); the decode steps on float32 KV caches on
  both sides (with bf16 caches, a key whose float32 value sits at a
  bf16 rounding edge may round one step apart, 2^-8 relative, and move
  the next steps' logits by more: 1.3e-4 observed);
* bf16 prefill: within √2 times the RMS distance that bf16 compute puts
  between the reference's logits and its float32 logits (two bf16
  evaluations that round at different places sit about √2 times one
  evaluation's distance apart, ``tests/test_torch_hybrid.py``), over
  the rows whose bf16 routing is the float32 routing.  A token whose
  router logits sit at a near-tie may take another expert under bf16
  rounding (grok-1-314b's smoke config: one token of 32, its gap
  0.0115), a discrete change no rounding distance bounds; such a row is
  counted and left out, and each such token's gap must lie within what
  its own logits moved;
* the train step: the loss to 1e-5 relative and each parameter's update
  to 1e-6 absolute, exempt only the elements that part where the
  gradient is nonzero and within one fixed-point quantum of 0 (under 1 %,
  ``tests/test_torch_train.py``; the embedding rows no token reads have
  a gradient of exactly 0 on both sides, and are held);
* greedy tokens: equal, except after a step where the reference's two
  largest logits lie within the logits' tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as j_get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.steps import place
from repro.launch.train import make_mesh_for_host
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data import lm_batch
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill
from repro_torch.models import moe, transformer
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
LOGIT_TOL = 1e-4
OUT_TOL = 1e-6
QUANTUM = 2.0 ** -16
PROMPT, GEN, BATCH, SEQ = 4, 4, 2, 16
DECODE_STEPS = 8


def _configs(arch, compute="float32", **kw):
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True),
                                compute_dtype=compute, **kw)
    t_cfg = dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=compute, **kw)
    return j_cfg, t_cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's smoke parameters plus numpy noise: ``(arrays by
    path, jax tree)``."""
    j_cfg, _ = _configs(arch)
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


def _port_params(arch, compute="float32", **kw):
    _, cfg = _configs(arch, compute, **kw)
    model = transformer.from_reference(cfg, _weights(arch)[0], device="cpu")
    return cfg, model.params()


# ---------------------------------------------------------------------------
# moe_apply: routing, positions, drops
# ---------------------------------------------------------------------------

class _Spy:
    """``real``'s attributes, some replaced."""

    def __init__(self, real, **overrides):
        self._real, self._over = real, overrides

    def __getattr__(self, name):
        if name in self._over:
            return self._over[name]
        return getattr(self._real, name)


def _j_moe_apply(monkeypatch, params, x, cfg):
    """The reference's ``moe_apply`` run op by op, with its top-k
    choices and its ``slot`` arguments read on the way: ``(out, eidx
    [T, k], pos [T·k], keep [T·k])``."""
    seen = {}

    def top_k(a, k):
        gates, eidx = jax.lax.top_k(a, k)
        seen["eidx"] = np.asarray(eidx)
        return gates, eidx

    def where(cond, a, b):
        seen["keep"], seen["slot_if_kept"] = np.asarray(cond), np.asarray(a)
        return jnp.where(cond, a, b)

    monkeypatch.setattr(j_moe, "jax", _Spy(jax, lax=_Spy(jax.lax,
                                                          top_k=top_k)))
    monkeypatch.setattr(j_moe, "jnp", _Spy(jnp, where=where))
    out = np.asarray(j_moe.moe_apply(params, x, cfg))
    monkeypatch.undo()
    cap = moe.capacity(x.shape[0] * x.shape[1], cfg)
    flat_e = seen["eidx"].reshape(-1)
    return out, seen["eidx"], seen["slot_if_kept"] - flat_e * cap, \
        seen["keep"]


def _moe_case(case, e=4, d=64, f=32, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    params = {"router": rng.randn(d, e).astype(np.float32) / 8,
              "w_gate": rng.randn(e, d, f).astype(np.float32) / 8,
              "w_up": rng.randn(e, d, f).astype(np.float32) / 8,
              "w_down": rng.randn(e, f, d).astype(np.float32) / 6}
    x = rng.randn(b, s, d).astype(np.float32)
    if case == "zero_input":
        x[:] = 0.0          # every logit 0: the lowest k indices win
    elif case == "zero_columns":
        # experts 1 and 3 score exactly 0 for every token: whenever both
        # sit at the top-k boundary, expert 1 is chosen before 3
        params["router"][:, [1, 3]] = 0.0
    return params, x


@pytest.mark.parametrize("dispatch", ["cumsum", "sort"])
@pytest.mark.parametrize("case,cf", [("random", 1.25), ("random", 0.5),
                                     ("zero_input", 0.5),
                                     ("zero_columns", 0.5)])
def test_moe_apply_routes_and_drops_as_the_reference(monkeypatch, dispatch,
                                                     case, cf):
    j_cfg, cfg = _configs("qwen3-moe-235b-a22b", moe_dispatch=dispatch,
                          capacity_factor=cf)
    params, x = _moe_case(case)
    want, j_eidx, j_pos, j_keep = _j_moe_apply(
        monkeypatch, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x), j_cfg)
    t_params = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    _, _, eidx = moe.route(t_params, xt.reshape(-1, x.shape[-1]), cfg)
    cap = moe.capacity(x.shape[0] * x.shape[1], cfg)
    pos, keep = moe.positions(eidx, cap, cfg)
    np.testing.assert_array_equal(eidx.numpy(), j_eidx)
    np.testing.assert_array_equal(pos.numpy(), j_pos)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    if cf < 1:
        assert not j_keep.all()      # the capacity drops assignments
    if case == "zero_input":
        assert (j_eidx == np.arange(cfg.top_k)).all()
    if case == "zero_columns":
        assert ((j_eidx == 1).any(1) & ~(j_eidx == 3).any(1)).any()
    with moe.record_routing() as rec:
        got = moe.moe_apply(t_params, xt, cfg)
    assert len(rec) == 1 and torch.equal(rec[0]["eidx"], eidx)
    assert torch.equal(rec[0]["keep"].reshape(-1), keep)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)


def test_sort_mode_priority_is_token_major():
    """The two modes part where a token's second choice competes with a
    later token's first choice for the last slot of an expert: the
    cumsum mode keeps rank 0 first, the sort mode the earlier token."""
    cfg = dataclasses.replace(get_config("grok-1-314b", smoke=True),
                              capacity_factor=0.25)
    eidx = torch.tensor([[1, 0]] + [[0, 2]] * 9)    # expert 0: 10 rows
    cap = moe.capacity(10, cfg)
    assert cap == 8
    pos_c, keep_c = moe.positions(eidx, cap, cfg)
    pos_s, keep_s = moe.positions(eidx, cap, dataclasses.replace(
        cfg, moe_dispatch="sort"))
    # token 0's second choice (expert 0): after the 9 first choices in
    # cumsum order, first in sort order
    assert pos_c.reshape(10, 2)[0, 1] == 9 and not keep_c.reshape(10, 2)[0, 1]
    assert pos_s.reshape(10, 2)[0, 1] == 0 and keep_s.reshape(10, 2)[0, 1]


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.RandomState(4)
    logits = rng.randn(64, 8).astype(np.float32)
    eidx = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    want = float(j_moe.aux_load_balance_loss(jnp.asarray(logits),
                                             jnp.asarray(eidx), 8))
    got = float(moe.aux_load_balance_loss(torch.from_numpy(logits),
                                          torch.from_numpy(eidx).long(), 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


# ---------------------------------------------------------------------------
# the model: schema, prefill, loss, gradients, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_is_the_references(arch):
    j_cfg = j_get_config(arch)
    abstract = jax.eval_shape(
        lambda: j_transformer.init(jax.random.PRNGKey(0), j_cfg))
    want = {"/".join(str(p) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                abstract)[0]}
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    model = transformer.init(cfg, device="meta")
    got = {path_str(p): tuple(leaf.shape)
           for p, leaf in flatten_with_path(model.params())}
    assert list(got) == list(want) and got == want
    assert len(got) == 13
    assert got["['layers']/['b0_moe_attn']/['moe']/['w_gate']"] == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    # the analytic count leaves out the final norm's scale
    assert sum(int(np.prod(s)) for s in got.values()) == \
        cfg.param_count() + cfg.d_model
    assert transformer.stack_plan(cfg) == (("moe_attn",), cfg.n_layers, ())


@functools.lru_cache(maxsize=None)
def _reference_forward(arch, dispatch="cumsum"):
    """Float32 compute, ``dispatch`` mode: prefill, loss and gradients on
    a seeded batch."""
    j_cfg, _ = _configs(arch, moe_dispatch=dispatch)
    _, params = _weights(arch)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    labels = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    prefill = jax.jit(functools.partial(j_transformer.prefill, cfg=j_cfg))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_transformer.loss_fn(p, batch, j_cfg)))(params)
    return {"tokens": tokens, "labels": labels,
            "prefill": np.asarray(prefill(params, batch)),
            "loss": float(loss),
            "grads": {"/".join(str(p) for p in path): np.asarray(g)
                      for path, g in jax.tree_util.tree_flatten_with_path(
                          grads)[0]}}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """Float32 compute: the forward's results, an 8-step decode
    trajectory and the reference's serve loop."""
    j_cfg, _ = _configs(arch)
    _, params = _weights(arch)
    prompt = np.random.RandomState(1).randint(0, j_cfg.vocab,
                                              size=(BATCH, PROMPT))
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    cache = j_transformer.init_cache(j_cfg, BATCH, DECODE_STEPS,
                                     dtype=jnp.float32)
    inputs, logits = [], []
    tok = prompt[:, :1]
    for t in range(DECODE_STEPS):
        inputs.append(np.asarray(tok, np.int32))
        out, cache = step(params, cache, {
            "tokens": jnp.asarray(tok, jnp.int32), "index": jnp.int32(t)})
        logits.append(np.asarray(out))
        tok = (prompt[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.argmax(logits[-1], -1)[:, None])
    # the reference's own serve loop (repro/launch/serve.py::main)
    kv_len = PROMPT + GEN
    mesh = make_mesh_for_host(1)
    wrap, _, _ = j_make_serve_step(j_cfg, mesh, kv_len=kv_len, batch=BATCH)
    serve = wrap({"tokens": jax.ShapeDtypeStruct((BATCH, 1), jnp.int32),
                  "index": jax.ShapeDtypeStruct((), jnp.int32)})
    s_cache = j_transformer.init_cache(j_cfg, BATCH, kv_len)
    served = []
    with compat.set_mesh(mesh):
        tok = jnp.asarray(prompt[:, :1], jnp.int32)
        for t in range(kv_len):
            nxt, s_cache = serve(params, s_cache,
                                 {"tokens": tok, "index": jnp.int32(t)})
            if t + 1 < PROMPT:
                tok = jnp.asarray(prompt[:, t + 1:t + 2], jnp.int32)
            else:
                tok = nxt[:, None]
                if t >= PROMPT:
                    served.append(np.asarray(nxt))
    return {**_reference_forward(arch), "prompt": prompt,
            "inputs": inputs, "logits": logits,
            "served": np.stack(served, 1)}


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("dispatch", ["cumsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_loss_and_gradients_match_reference(arch, dispatch):
    ref = _reference_forward(arch, dispatch)
    cfg, params = _port_params(arch, moe_dispatch=dispatch)
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "labels": torch.from_numpy(ref["labels"])}
    with moe.record_routing() as rec:
        got = make_prefill(cfg, device="cpu")(params, batch)
    # one routing a layer, every assignment of B·S tokens
    assert len(rec) == cfg.n_layers
    assert rec[0]["eidx"].shape == (BATCH * SEQ, cfg.top_k)
    assert got.dtype == torch.float32 and got.shape == (BATCH, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)
    flat = flatten_with_path(params)
    loss = transformer.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0,
                               atol=LOGIT_TOL)
    assert len(grads) == len(ref["grads"]) == 13
    for (path, _), g in zip(flat, grads):
        want = ref["grads"][path_str(path)]
        assert g.shape == want.shape
        assert np.abs(g.numpy() - want).max() <= \
            LOGIT_TOL * np.abs(want).max(), path_str(path)
    # the router and every expert weight carry a gradient
    by_path = {path_str(p): g for (p, _), g in zip(flat, grads)}
    for leaf in ("router", "w_gate", "w_up", "w_down"):
        g = by_path[f"['layers']/['b0_moe_attn']/['moe']/['{leaf}']"]
        assert float(g.abs().max()) > 0, leaf


def _rows_rerouted(rec_a, rec_b, batch):
    """Batch rows where two forwards' routings part (a token's expert set
    or ``keep`` differs in some layer).  Each token whose expert set
    differs must sit at a near-tie its own router-logit change explains:
    the gap between its k-th and (k+1)-th logit in ``rec_b`` at most
    twice the largest change of its logits."""
    rows = np.zeros(batch, bool)
    for a, b in zip(rec_a, rec_b):
        k = a["eidx"].shape[1]
        sets_a = np.sort(a["eidx"].numpy(), 1)
        sets_b = np.sort(b["eidx"].numpy(), 1)
        differ = (sets_a != sets_b).any(1)
        top = np.sort(b["logits"].numpy(), 1)[:, ::-1]
        gap = top[:, k - 1] - top[:, k]
        change = np.abs(a["logits"].numpy() - b["logits"].numpy()).max(1)
        assert (gap[differ] <= 2 * change[differ]).all(), (
            gap[differ], change[differ])
        moved = differ | (a["keep"].numpy() != b["keep"].numpy()).any(1)
        rows |= moved.reshape(batch, -1).any(1)
    return rows


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_bf16_within_the_references_bf16_distance(arch):
    """The bf16 logits against the reference's bf16 and float32 logits,
    on the rows whose routing in bf16 is the routing in float32: a token
    at a near-tie of its router logits may take another expert in one
    bf16 evaluation and not in another, a discrete change that no
    rounding distance bounds; such rows are counted and left out."""
    ref = _reference(arch)
    j_cfg, _ = _configs(arch, "bfloat16")
    _, j_params = _weights(arch)
    want = np.asarray(jax.jit(functools.partial(
        j_transformer.prefill, cfg=j_cfg))(
            j_params, {"tokens": jnp.asarray(ref["tokens"], jnp.int32)}))
    recs, got = {}, {}
    for compute in ("bfloat16", "float32"):
        cfg, params = _port_params(arch, compute)
        with moe.record_routing() as recs[compute]:
            got[compute] = make_prefill(cfg, device="cpu")(
                params, {"tokens": torch.from_numpy(ref["tokens"])}).numpy()
    np.testing.assert_allclose(got["float32"], ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)
    keep = ~_rows_rerouted(recs["bfloat16"], recs["float32"], BATCH)
    assert keep.any()
    got, want, f32 = got["bfloat16"][keep], want[keep], ref["prefill"][keep]
    rms = {name: float(np.sqrt(np.mean(np.square(e)))) for name, e in (
        ("vs_bf16", got - want), ("vs_f32", got - f32),
        ("noise", want - f32))}
    assert rms["noise"] > 0
    assert max(rms["vs_bf16"], rms["vs_f32"]) <= np.sqrt(2) * rms["noise"], \
        f"bf16 logits: RMS {rms} over {int(keep.sum())} rows"


@pytest.mark.parametrize("dispatch", ["cumsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_generate_match_reference(arch, dispatch):
    """8 decode steps (the prompt, then greedy tokens) on a float32 KV
    cache, each step's logits against the reference's, then
    ``generate`` (the bf16 cache) against its serve loop.  Decode routes
    B = 2 tokens under a capacity of 8: the two modes agree there, and
    both run."""
    ref = _reference(arch)
    cfg, params = _port_params(arch, moe_dispatch=dispatch)
    cache = transformer.init_cache(cfg, BATCH, DECODE_STEPS,
                                   dtype=torch.float32, device="cpu")
    assert set(cache["groups"]) == {"b0_moe_attn"}
    with torch.no_grad():
        for t, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": torch.from_numpy(tok), "index": t},
                cfg)
            got = logits.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"step {t}")
            tie = _top2_gap(want) <= LOGIT_TOL
            assert ((got.argmax(-1) == want.argmax(-1)) | tie).all(), \
                f"step {t}: greedy tokens differ"
    got = generate(cfg, params, ref["prompt"], GEN, device="cpu")["tokens"]
    assert got.shape == ref["served"].shape == (BATCH, GEN)
    for t in range(GEN):
        if any((_top2_gap(ref["logits"][i]) <= LOGIT_TOL).any()
               for i in (PROMPT - 1 + t, PROMPT + t)
               if i < len(ref["logits"])):
            break  # a near-tie: the loops may part from here on
        np.testing.assert_array_equal(got[:, t], ref["served"][:, t],
                                      err_msg=f"generated token {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_over_the_prompt_ends_on_prefill_without_drops(arch):
    """With a capacity factor of E/k no assignment drops in prefill (the
    capacity is at least the B·S tokens) nor in decode (at least 8 ≥ B):
    both compute the same function, and the last prompt step's logits
    are the prefill's (a float32 cache)."""
    _, base = _configs(arch)
    cf = base.n_experts / base.top_k
    cfg, params = _port_params(arch, capacity_factor=cf)
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab, size=(BATCH, SEQ)))
    with moe.record_routing() as rec:
        pre = make_prefill(cfg, device="cpu")(params, {"tokens": prompt})
    assert all(bool(r["keep"].all()) for r in rec)
    cache = transformer.init_cache(cfg, BATCH, SEQ, dtype=torch.float32,
                                   device="cpu")
    with torch.no_grad(), moe.record_routing() as rec:
        for t in range(SEQ):
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": prompt[:, t:t + 1], "index": t},
                cfg)
    assert all(bool(r["keep"].all()) for r in rec)
    np.testing.assert_allclose(logits.numpy(), pre.numpy(), rtol=0,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# training: one secure step against the reference's, MPC-FSDP at one party
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dispatch", [
    ("qwen3-moe-235b-a22b", "cumsum"), ("grok-1-314b", "cumsum"),
    ("grok-1-314b", "sort")])
def test_one_train_step_matches_reference(arch, dispatch):
    """One two_phase additive step of the reference (a (1, 1) mesh) and of
    the port (a world of one) from the same weights and batch."""
    arrays, tree = _weights(arch)
    j_cfg, t_cfg = _configs(arch, moe_dispatch=dispatch)
    toks, labels = lm_batch(256, 8, 16, seed=0, party=0, step=0)
    j_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    mesh = make_host_mesh(1, 1)
    wrap, _, _ = j_make_train_step(j_cfg, mesh, protocol="two_phase",
                                   scheme="additive", m=3, seed=0,
                                   fsdp=False, donate=False,
                                   opt=JAdamWConfig(lr=3e-4))
    step, sh = wrap({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in j_batch.items()})
    params = place(tree, sh["params"])
    with compat.set_mesh(mesh):
        p_j, _, loss_j = step(params, place(j_adamw_init(params), sh["opt"]),
                              jnp.int32(0), j_batch)

    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    t_step = steps.make_train_step(t_cfg, protocol="two_phase",
                                   scheme="additive", m=3, seed=0,
                                   opt=AdamWConfig(lr=3e-4), device="cpu")
    assert not t_step.fsdp
    grads = {}
    t_step.observe = lambda g, agg: grads.update(
        (path_str(p), leaf.numpy()) for p, leaf in flatten_with_path(g))
    model, _, loss_t = t_step(model, adamw_init(model.params()), 0,
                              {"tokens": toks, "labels": labels})
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = transformer.to_reference(model)
    exempt = total = 0
    for path, w in jax.tree_util.tree_flatten_with_path(p_j)[0]:
        key = "/".join(str(p) for p in path)
        want = np.asarray(w, np.float64) - arrays[key]
        upd = np.asarray(got[key], np.float64) - arrays[key]
        # an exact 0 (an embedding row no token of the batch reads) encodes
        # to 0 on both sides and is held like the rest
        near0 = (np.abs(grads[key]) < QUANTUM) & (grads[key] != 0)
        parted = near0 & (np.abs(upd - want) > 1e-6)
        np.testing.assert_allclose(upd[~parted], want[~parted], rtol=0,
                                   atol=1e-6, err_msg=key)
        exempt += int(parted.sum())
        total += near0.size
    assert exempt < 0.01 * total, (exempt, total)

