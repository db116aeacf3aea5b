"""The port's SSM serving path (falcon-mamba-7b) against the JAX
package's: the selective scan's plain version, the chunked scan, the
weights, prefill, the loss, the decode step and the greedy serve loop,
on the CPU.

Inputs come from numpy seeds.  The reference's Pallas kernel runs in
interpret mode, as its own tests run it on the CPU; the model carries
the reference's smoke weights (perturbed with numpy noise, so the zero
biases and unit scales matter) across by ``from_reference``.

Tolerances and why:

* the selective scan: the reference's own (5e-5 absolute, 1e-4
  relative, ``tests/test_kernels.py``) — the same recurrence, with the
  sum over the state in another order and ``exp`` from another library;
* the chunked scan: 1e-6 absolute + 1e-5 relative in float32 — the
  port combines the same operands in the same order, but it is not bit
  for bit equal: XLA's CPU backend contracts ``a2·b1 + b2`` into one
  fused multiply-add where PyTorch rounds the product first (half the
  elements differ, by at most ~1e-6); in bfloat16 the same plus one
  bf16 step (2^-8 relative) for the same reason;
* model logits and loss in float32 compute: 1e-4 absolute — the same
  function through 2 layers, with sums in another order;
* decode states in float32 compute: 1e-5 absolute;
* bfloat16 compute: one SSM block step's float32 states to 1e-6 and
  its bf16 output to one bf16 step of its largest element; the model's
  logits within the distance (RMS) that bf16 compute puts between the
  reference's logits and its float32 logits on the same tokens — XLA
  keeps excess precision in fused bf16 chains where PyTorch rounds each
  result, and the hidden state carries such steps from layer to layer;
* greedy tokens: equal, except at a step where the reference's two
  largest logits lie within the logits' tolerance (a near-tie).
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
from repro.kernels.ssm_scan.kernel import ssm_scan_pallas
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.train import make_mesh_for_host
from repro.models import transformer as j_transformer
from repro.models.scan_utils import \
    chunked_linear_scan as j_chunked_linear_scan
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill
from repro_torch.models import ssm, transformer
from repro_torch.models.scan_utils import chunked_linear_scan

ARCH = "falcon-mamba-7b"
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
PROMPT, GEN, BATCH = 4, 4, 2
SEQ = 128  # two chunks of the scan: the carry across them counts


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# the selective scan's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _scan_inputs(s, di, st, b=2):
    """The reference's sweep inputs (``tests/test_kernels.py``)."""
    rng = np.random.RandomState(s + di)
    return (rng.randn(b, s, di).astype(np.float32),
            np.abs(rng.randn(b, s, di)).astype(np.float32) * 0.1,
            rng.randn(b, s, st).astype(np.float32) * 0.5,
            rng.randn(b, s, st).astype(np.float32) * 0.5,
            -np.abs(rng.randn(di, st)).astype(np.float32))


@pytest.mark.parametrize("s,di,st,bt", [(128, 128, 16, 64),
                                        (256, 256, 16, 128),
                                        (256, 128, 8, 32)])
def test_ssm_scan_plain_version_matches_pallas_kernel(s, di, st, bt):
    arrays = _scan_inputs(s, di, st)
    j_in = [jnp.asarray(a) for a in arrays]
    want = np.asarray(ssm_scan_pallas(*j_in, block_t=bt, interpret=True))
    oracle = np.asarray(j_ssm_scan_ref(*j_in))
    got = ssm_scan_ref(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.float32 and got.shape == (2, s, di)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=5e-5, rtol=1e-4)
    # the wrapper on CPU tensors is the plain version, in x's dtype
    via = ssm_scan(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(via, got)


def test_ssm_scan_plain_version_takes_ragged_shapes():
    # S % 128 and di % 128 != 0: the reference's wrapper sends these to
    # its oracle; the port's kernel masks the channel tail
    arrays = _scan_inputs(100, 72, 4)
    want = np.asarray(j_ssm_scan_ref(*(jnp.asarray(a) for a in arrays)))
    got = ssm_scan(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(128, 64), (36, 12)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_linear_scan_matches_reference(s, chunk, with_h0, dtype):
    # (36, 12) takes the recursion's odd branch (12 -> 6 -> 3 -> 1)
    rng = np.random.RandomState(s + chunk + with_h0)
    a = rng.uniform(0.5, 1.0, size=(2, s, 8, 4)).astype(np.float32)
    b = rng.randn(2, s, 8, 4).astype(np.float32)
    h0 = rng.randn(2, 8, 4).astype(np.float32) if with_h0 else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j_args = [jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)]
    t_args = [_t(x).to(tdt) for x in j_args]
    j_h0 = None if h0 is None else jnp.asarray(h0).astype(jdt)
    t_h0 = None if h0 is None else _t(j_h0).to(tdt)
    want_hs, want_last = j_chunked_linear_scan(*j_args, h0=j_h0,
                                               chunk=chunk)
    hs, last = chunked_linear_scan(*t_args, h0=t_h0, chunk=chunk)
    assert hs.dtype == tdt and hs.shape == (2, s, 8, 4)
    rtol = 1e-5 + (2.0 ** -8 if dtype == "bfloat16" else 0.0)
    for got, want in ((hs, want_hs), (last, want_last)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=1e-6, rtol=rtol)


def test_chunked_linear_scan_keeps_the_chunk_rule():
    a = np.ones((1, 100, 2), np.float32)
    with pytest.raises(AssertionError):
        j_chunked_linear_scan(jnp.asarray(a), jnp.asarray(a), chunk=64)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        chunked_linear_scan(_t(a), _t(a), chunk=64)


# ---------------------------------------------------------------------------
# the model: weights, prefill, loss, decode step, serve loop
# ---------------------------------------------------------------------------

def _configs(compute="float32"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True),
                                compute_dtype=compute),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                compute_dtype=compute))


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's smoke weights, each leaf perturbed by numpy noise;
    ``dt_bias`` is moved from softplus^-1(0.01) to about -1.6, so the
    scan's term of y is not swamped by ``x·D``."""
    j_cfg, _ = _configs()
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {}
    for path, leaf in flat:
        name = "/".join(str(p) for p in path)
        arrays[name] = (np.asarray(leaf) + rng.randn(*leaf.shape).astype(
            np.float32) * 0.05 + (3.0 if "dt_bias" in name else 0.0))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    return arrays, params


def _j_trajectory(compute, prompt, kv_len):
    """The reference's greedy trajectory through its jitted
    ``decode_step``: inputs, logits and the states after each step."""
    j_cfg, _ = _configs(compute)
    _, params = _weights()
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    cache = j_transformer.init_cache(j_cfg, BATCH, kv_len)
    inputs, logits, states = [], [], []
    tok = prompt[:, :1]
    for t in range(kv_len):
        inputs.append(np.asarray(tok, np.int32))
        out, cache = step(params, cache, {"tokens": jnp.asarray(tok,
                                                                jnp.int32),
                                          "index": jnp.int32(t)})
        logits.append(np.asarray(out))
        states.append({k: np.asarray(v)
                       for k, v in cache["groups"]["b0_ssm"].items()})
        tok = (prompt[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.argmax(logits[-1], -1)[:, None])
    return inputs, logits, states


@functools.lru_cache(maxsize=None)
def _reference():
    """Float32 compute: the trajectory, the reference's ``make_serve_step``
    loop's tokens, prefill and loss over a 128-token batch."""
    j_cfg, _ = _configs()
    _, params = _weights()
    prompt = np.random.RandomState(1).randint(0, j_cfg.vocab,
                                              size=(BATCH, PROMPT))
    kv_len = PROMPT + GEN
    inputs, logits, states = _j_trajectory("float32", prompt, kv_len)
    # the reference's own serve loop (repro/launch/serve.py::main)
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
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    labels = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    return {"prompt": prompt, "inputs": inputs, "logits": logits,
            "states": states, "served": np.stack(served, 1),
            "tokens": tokens, "labels": labels,
            "prefill": np.asarray(j_transformer.prefill(params, batch,
                                                        j_cfg)),
            "loss": float(j_transformer.loss_fn(params, batch, j_cfg))}


def _port_params(compute="float32"):
    _, t_cfg = _configs(compute)
    model = transformer.from_reference(t_cfg, _weights()[0], device="cpu")
    return t_cfg, model.params()


def test_from_reference_carries_the_ssm_tree():
    arrays, params = _weights()
    cfg, _ = _port_params()
    model = transformer.from_reference(cfg, arrays, device="cpu")
    back = transformer.to_reference(model)
    assert len(back) == 13 and set(back) == set(arrays)
    assert "['layers']/['b0_ssm']/['ssm']/['A_log']" in back
    for name, want in arrays.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    # A_log and D stay float32 whatever param_dtype
    bf = transformer.init(dataclasses.replace(cfg, param_dtype="bfloat16"),
                          device="cpu").params()["layers"]["b0_ssm"]["ssm"]
    assert bf["A_log"].dtype == bf["D"].dtype == torch.float32
    assert bf["in_proj"].dtype == torch.bfloat16


def test_flattened_leaves_are_freed_with_their_last_reference():
    """``flatten_with_path`` leaves no reference cycle behind: a layer
    that ``transformer.init`` drew and copied into its stacks is freed
    at once, not when the garbage collector runs."""
    import gc
    import weakref
    from repro_torch.core.tree import flatten_with_path
    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    enabled = gc.isenabled()
    gc.disable()
    try:
        flat = flatten_with_path({"a": {"b": leaf}, "c": torch.ones(2)})
        assert [p for p, _ in flat] == [("a", "b"), ("c",)]
        del flat, leaf
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_prefill_and_loss_match_reference():
    ref = _reference()
    cfg, params = _port_params()
    batch = {"tokens": torch.from_numpy(ref["tokens"]),
             "labels": torch.from_numpy(ref["labels"])}
    got = make_prefill(cfg, device="cpu")(params, batch)
    assert got.dtype == torch.float32 and got.shape == (BATCH, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)
    with torch.no_grad():
        loss = transformer.loss_fn(params, batch, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0,
                               atol=LOGIT_TOL)


def test_decode_step_matches_reference():
    ref = _reference()
    cfg, params = _port_params()
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cpu")
    state = cache["groups"]["b0_ssm"]
    assert set(state) == {"conv", "ssm"}
    assert state["conv"].shape == (cfg.n_layers, BATCH, cfg.ssm_conv - 1,
                                   cfg.d_inner)
    assert state["ssm"].shape == (cfg.n_layers, BATCH, cfg.d_inner,
                                  cfg.ssm_state)
    assert state["conv"].dtype == state["ssm"].dtype == torch.float32
    dispatch.reset_launches()
    with torch.no_grad():
        for t, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": torch.from_numpy(tok), "index": t},
                cfg)
            got = logits.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"step {t}")
            tie = _top2_gap(want) <= LOGIT_TOL
            same = got.argmax(-1) == want.argmax(-1)
            assert (same | tie).all(), f"step {t}: greedy tokens differ"
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(
                    state[key].numpy(), ref["states"][t][key], rtol=0,
                    atol=STATE_TOL, err_msg=f"step {t} {key}")
    assert all(v == 0 for v in dispatch.launches.values())


def test_decode_step_bf16_promotes_to_float32_as_the_reference():
    """In bf16 compute the float32 conv state promotes the step to
    float32 against bf16-rounded weights (``jnp`` promotion); the port
    casts on purpose.  One block step on the same inputs: the conv state
    equal, the SSM state to 1e-6 (a step that ran x_c in bf16 would be
    ~1e-3 off), y within one bf16 step of its largest element; then
    the model's bf16 trajectory."""
    from repro.models import ssm as j_ssm
    j_cfg, cfg = _configs("bfloat16")
    _, j_params = _weights()
    jp = {k: v[0] for k, v in j_params["layers"]["b0_ssm"]["ssm"].items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.RandomState(7)
    x = rng.randn(BATCH, cfg.d_model).astype(np.float32)
    conv = rng.randn(BATCH, cfg.ssm_conv - 1, cfg.d_inner).astype(np.float32)
    h = (rng.randn(BATCH, cfg.d_inner, cfg.ssm_state) * 0.1).astype(
        np.float32)
    j_y, j_state = j_ssm.ssm_block_step(
        jp, jnp.asarray(x).astype(jnp.bfloat16),
        {"conv": jnp.asarray(conv), "ssm": jnp.asarray(h)}, j_cfg)
    state = {"conv": torch.from_numpy(conv.copy()),
             "ssm": torch.from_numpy(h.copy())}
    y, _ = ssm.ssm_block_step(tp, torch.from_numpy(x).to(torch.bfloat16),
                              state, cfg)
    assert y.dtype == torch.bfloat16
    assert state["conv"].dtype == state["ssm"].dtype == torch.float32
    np.testing.assert_array_equal(state["conv"].numpy(),
                                  np.asarray(j_state["conv"]))
    np.testing.assert_allclose(state["ssm"].numpy(),
                               np.asarray(j_state["ssm"]), rtol=0,
                               atol=1e-6)
    # y is a bf16 product of bf16-rounded factors (silu(z) rounds apart
    # near an edge): one bf16 step of the largest output
    want_y = np.asarray(j_y.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=0,
                               atol=2.0 ** -7 * np.abs(want_y).max())

    # the model's bf16 trajectory: within the distance (RMS over every
    # logit) that bf16 compute puts between the reference's logits and
    # its float32 logits on the same tokens
    ref = _reference()
    inputs, want_logits, _ = _j_trajectory("bfloat16", ref["prompt"],
                                           PROMPT + GEN)
    j_cfg32, _ = _configs()
    step32 = jax.jit(functools.partial(j_transformer.decode_step,
                                       cfg=j_cfg32))
    j_cache = j_transformer.init_cache(j_cfg32, BATCH, PROMPT + GEN)
    _, params = _port_params("bfloat16")
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cpu")
    err, noise = [], []
    with torch.no_grad():
        for t, (tok, want) in enumerate(zip(inputs, want_logits)):
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": torch.from_numpy(tok), "index": t},
                cfg)
            want32, j_cache = step32(j_params, j_cache,
                                     {"tokens": jnp.asarray(tok),
                                      "index": jnp.int32(t)})
            err.append(logits.numpy() - want)
            noise.append(np.asarray(want32) - want)
    rms = [float(np.sqrt(np.mean(np.square(e)))) for e in (err, noise)]
    assert rms[0] <= rms[1], f"bf16 logits: RMS {rms[0]} against {rms[1]}"


def test_generate_matches_reference_serve_loop():
    ref = _reference()
    cfg, params = _port_params()
    got = generate(cfg, params, ref["prompt"], GEN, device="cpu")["tokens"]
    want = ref["served"]
    assert got.shape == want.shape == (BATCH, GEN) and got.dtype == np.int32
    for t in range(GEN):
        if any((_top2_gap(ref["logits"][i]) <= LOGIT_TOL).any()
               for i in (PROMPT - 1 + t, PROMPT + t)):
            break  # a near-tie: the loops may part from here on
        np.testing.assert_array_equal(got[:, t], want[:, t],
                                      err_msg=f"generated token {t}")


def test_decode_matches_prefill_logits():
    """Greedy decode == teacher-forced forward (causality), in the
    config's bf16, at the reference's own tolerance
    (``test_decode_matches_prefill_logits``)."""
    cfg = get_config(ARCH, smoke=True)
    model = transformer.init(cfg, seed=0, device="cpu")
    params = model.params()
    b, s = 1, 8
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, size=(b, s)))
    with torch.no_grad():
        h = transformer.forward_hidden(params, {"tokens": toks}, cfg,
                                       impl="dense")
        w = transformer.lm_head_weight(params, cfg)
        full = (h @ w.to(h.dtype)).float()
        cache = transformer.init_cache(cfg, b, 16, device="cpu")
        for t in range(s):
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": toks[:, t:t + 1], "index": t}, cfg)
            np.testing.assert_allclose(logits[0].numpy(),
                                       full[0, t].numpy(), atol=8e-2,
                                       rtol=5e-2)


# ---------------------------------------------------------------------------
# the scan's path rule
# ---------------------------------------------------------------------------

def test_scan_rule_keeps_autograd_off_the_ssm_kernel(monkeypatch):
    cfg, params = _port_params()
    p = {k: v.detach()[0] for k, v in params["layers"]["b0_ssm"][
        "ssm"].items()}
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 64, cfg.d_model).astype(np.float32))
    calls = []
    real = ssm.ssm_scan
    monkeypatch.setattr(ssm, "ssm_scan",
                        lambda *a: calls.append(1) or real(*a))
    dense = ssm.ssm_block_apply(p, x, cfg, impl="dense")
    # on the CPU "auto" is the chunked path, as the reference's off a TPU
    auto = ssm.ssm_block_apply(p, x, cfg)
    assert not calls and torch.equal(auto, dense)
    # "pallas" runs the wrapper (here its plain version): the same function
    kern = ssm.ssm_block_apply(p, x, cfg, impl="pallas")
    assert calls == [1]
    np.testing.assert_allclose(kern.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    # while autograd records, "pallas" raises and "auto" differentiates
    # through the chunked path
    pg = dict(p, in_proj=p["in_proj"].clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="queue 3, finding 5"):
        ssm.ssm_block_apply(pg, x, cfg, impl="pallas")
    out = ssm.ssm_block_apply(pg, x, cfg)
    out.sum().backward()
    assert pg["in_proj"].grad is not None and calls == [1]
    np.testing.assert_allclose(out.detach().numpy(), dense.numpy(), rtol=0,
                               atol=0)
    # the wrapper on a CUDA-marked call while autograd records raises
    # before it reaches the card
    xs = [torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8)),
          torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)),
          torch.zeros((8, 2), requires_grad=True)]
    monkeypatch.setattr(dispatch, "on_cpu", lambda *t: False)
    with pytest.raises(NotImplementedError, match="queue 3, finding 5"):
        real(*xs)
