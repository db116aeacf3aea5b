"""The port's hybrid serving path (recurrentgemma-9b) against the JAX
package's: the RG-LRU scan's plain version, the rec block, GeGLU, the
weights, prefill, the loss, the decode step with its ring-buffer KV
cache, the serve step and the greedy serve loop, and the attention
kernels' plain versions at head dim 256, on the CPU.

Inputs come from numpy seeds.  The reference's Pallas scan runs in
interpret mode, as its own tests run it on the CPU; its model steps run
under ``jax.jit``.  The model carries the reference's smoke weights
(perturbed with numpy noise, so the zero biases and unit scales matter)
across by ``from_reference``.  The smoke config has one (rec, rec, attn)
triad and one tail rec layer, window 8.

Tolerances and why:

* the RG-LRU scan: 1e-6 absolute + 1e-5 relative, the chunked scan's —
  the same recurrence, but XLA's CPU backend may contract ``a·h + b``
  into one fused multiply-add where PyTorch rounds the product;
* the gated MLP in float32: 1e-6 — the same matmuls;
* the RG-LRU and the rec block in float32: 1e-5 absolute + 1e-5
  relative — the gates' matmuls, sigmoid, softplus and exp from another
  library, then the scan's tolerance; a rec block step's states 1e-5;
* in bfloat16: each result in x's dtype within two bf16 steps of its
  largest element — XLA keeps excess precision in fused bf16 chains
  where PyTorch rounds each result, and an element near a rounding edge
  lands a step apart; float32 states 1e-3 relative to their largest
  (they are computed in float32 from bf16 inputs that may sit one step
  apart);
* model logits and loss in float32 compute: 1e-4 absolute — the same
  function through 4 layers, with sums in another order; the reference
  divides scores by sqrt(Dh) where the port multiplies by its inverse;
  the decode steps' rec states to the logits' 1e-4 (states of magnitude
  up to ~4, computed through the same layers as the logits: over 20
  steps the first layer's stay within 1e-6 and the tail's conv state,
  behind three layers, reaches 4.4e-5); the bf16 KV caches 2^-7
  relative + 1e-6 absolute (a float32 key near a bf16 rounding edge may
  round one step apart);
* model logits in bfloat16 compute: within √2 times the distance (RMS
  over every logit) that bf16 compute puts between the reference's
  logits and its float32 logits on the same tokens, both from the
  reference's bf16 logits and from its float32 ones.  Two bf16
  evaluations of one function that round at different places sit about
  √2 times one evaluation's distance from float32 apart: the jitted
  reference keeps excess precision in fused chains where PyTorch (and
  the reference run op by op) rounds each result, and the hidden state
  carries those steps through 4 layers.  (Measured: the port's bf16
  logits are 1.13 times that distance from the reference's bf16 logits,
  1.14 times from its float32 logits; the reference run op by op is 1.18
  times it from its float32 logits.)  Each block alone is as close to
  float32 as the reference's (``test_rglru_and_rec_block_match_reference``);
* greedy tokens: equal, except at a step where the reference's two
  largest logits lie within the logits' tolerance (a near-tie);
* attention at head dim 256: the flash and decode plain versions'
  float32 tolerances (2e-5 absolute + 1e-4 relative; partials 1e-5).
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
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_decode_attention_ref
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.lru_scan.kernel import lru_scan_pallas
from repro.kernels.lru_scan.ref import lru_scan_ref as j_lru_scan_ref
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.train import make_mesh_for_host
from repro.models import attention as j_attention
from repro.models import hybrid as j_hybrid
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import decode_attention_partial
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.kernel import (fits_block,
                                                         split_plan)
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lru_scan import lru_scan, lru_scan_ref
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import hybrid, layers, transformer
from repro_torch.models.attention import xla_chunked_attention

ARCH = "recurrentgemma-9b"
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
PROMPT, GEN, BATCH = 4, 4, 2
SEQ = 24          # prefill length: the window of 8 binds
KV_LEN, STEPS = 32, 20  # a ring of min(32, 8) = 8 slots wraps twice


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bf16_steps(got, want, steps=2):
    """``got`` within ``steps`` bf16 steps (2^-8 relative) of ``want``'s
    largest element."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=steps * 2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the RG-LRU scan's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _lru_inputs(b, s, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.5, 1.0, size=(b, s, w)).astype(np.float32),
            rng.randn(b, s, w).astype(np.float32))


@pytest.mark.parametrize("b,s,w,bt", [(2, 256, 256, 128), (1, 256, 128, 64)])
def test_lru_scan_plain_version_matches_pallas_kernel(b, s, w, bt):
    a, bb = _lru_inputs(b, s, w, s + w + bt)
    want = np.asarray(lru_scan_pallas(jnp.asarray(a), jnp.asarray(bb),
                                      block_t=bt, interpret=True))
    oracle = np.asarray(j_lru_scan_ref(jnp.asarray(a), jnp.asarray(bb)))
    got = lru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    for ref in (want, oracle):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)
    # the wrapper on CPU tensors is the plain version, in a's dtype
    via = lru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    assert torch.equal(via, got)
    via16 = lru_scan(torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(bb).to(torch.bfloat16))
    assert via16.dtype == torch.bfloat16


def test_lru_scan_plain_version_takes_ragged_shapes_and_h0():
    # S % 128 and W % 128 != 0: the reference's wrapper sends these to
    # its oracle; the port's kernel masks the channel tail
    a, bb = _lru_inputs(2, 100, 72, 5)
    h0 = np.random.RandomState(6).randn(2, 72).astype(np.float32)
    for init in (None, h0):
        want = np.asarray(j_lru_scan_ref(
            jnp.asarray(a), jnp.asarray(bb),
            None if init is None else jnp.asarray(init)))
        got = lru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb),
                           None if init is None else torch.from_numpy(init))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the rec block: RG-LRU, the block, its decode step; GeGLU
# ---------------------------------------------------------------------------

def _configs(compute="float32"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True),
                                compute_dtype=compute),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                compute_dtype=compute))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's smoke weights, each leaf perturbed by numpy
    noise."""
    j_cfg, _ = _configs()
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {}
    for path, leaf in flat:
        name = "/".join(str(p) for p in path)
        arrays[name] = np.asarray(leaf) + rng.randn(*leaf.shape).astype(
            np.float32) * 0.05
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    return arrays, params


def _rec_params():
    """The first rec layer's block, as the reference's and the port's."""
    _, params = _weights()
    jp = jax.tree_util.tree_map(lambda v: v[0],
                                params["layers"]["b0_rec"]["rec"])
    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    return jp, tp


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_rglru_and_rec_block_match_reference(compute):
    j_cfg, cfg = _configs(compute)
    jp, tp = _rec_params()
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    rng = np.random.RandomState(8)
    x = jnp.asarray(rng.randn(BATCH, 64, cfg.d_model).astype(np.float32)
                    ).astype(jdt)
    u = jnp.asarray(rng.randn(BATCH, 64, cfg.lru_width).astype(np.float32)
                    ).astype(jdt)
    tx, tu = _t(x.astype(jnp.float32)).to(tdt), _t(u.astype(
        jnp.float32)).to(tdt)
    want_y, want_h = jax.jit(j_hybrid.rglru_apply)(jp["lru"], u)
    y, h = hybrid.rglru_apply(tp["lru"], tu, impl="dense")
    want_out = jax.jit(functools.partial(j_hybrid.rec_block_apply,
                                         cfg=j_cfg))(jp, x)
    out = hybrid.rec_block_apply(tp, tx, cfg, impl="dense")
    assert y.dtype == out.dtype == tdt and h.dtype == torch.float32
    if compute == "float32":
        for got, want in ((y, want_y), (h, want_h), (out, want_out)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    else:
        _bf16_steps(y, want_y)
        _bf16_steps(out, want_out)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0,
                                   atol=1e-3 * np.abs(want_h).max())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_rec_block_step_matches_reference(compute):
    """One decode step of the rec block: the conv state is cast to the
    compute dtype before the conv and back on store, h stays float32."""
    j_cfg, cfg = _configs(compute)
    jp, tp = _rec_params()
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    rng = np.random.RandomState(9)
    x = jnp.asarray(rng.randn(BATCH, cfg.d_model).astype(np.float32)
                    ).astype(jdt)
    conv = rng.randn(BATCH, 3, cfg.lru_width).astype(np.float32)
    h = (rng.randn(BATCH, cfg.lru_width) * 0.1).astype(np.float32)
    want_y, want_state = j_hybrid.rec_block_step(
        jp, x, {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}, j_cfg)
    state = {"conv": torch.from_numpy(conv.copy()),
             "h": torch.from_numpy(h.copy())}
    y, _ = hybrid.rec_block_step(tp, _t(x.astype(jnp.float32)).to(tdt),
                                 state, cfg)
    assert y.dtype == tdt
    assert state["conv"].dtype == state["h"].dtype == torch.float32
    if compute == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                                   atol=STATE_TOL)
        for key in ("conv", "h"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(want_state[key]), rtol=0,
                                       atol=STATE_TOL)
    else:
        _bf16_steps(y, want_y)
        for key in ("conv", "h"):
            want = np.asarray(want_state[key])
            np.testing.assert_allclose(state[key].numpy(), want, rtol=0,
                                       atol=1e-3 * np.abs(want).max())


def test_geglu_mlp_matches_reference():
    j_cfg, cfg = _configs()
    _, params = _weights()
    jp = jax.tree_util.tree_map(lambda v: v[0],
                                params["layers"]["b0_rec"]["mlp"])
    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    x = np.random.RandomState(10).randn(BATCH, 8, cfg.d_model).astype(
        np.float32)
    want = np.asarray(j_layers.mlp_apply(jp, jnp.asarray(x), j_cfg))
    got = layers.mlp_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the tanh form: the exact erf gelu is ~1e-4 away on these inputs
    g = torch.from_numpy(x) @ tp["w_gate"]
    assert not torch.allclose(layers.gelu(g), torch.nn.functional.gelu(g),
                              rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the scan's path rule
# ---------------------------------------------------------------------------

def test_scan_rule_keeps_autograd_off_the_lru_kernel(monkeypatch):
    _, tp = _rec_params()
    p = tp["lru"]
    u = torch.from_numpy(np.random.RandomState(4).randn(
        2, 64, 64).astype(np.float32))
    calls = []
    real = hybrid.lru_scan

    def spy(a, b):
        calls.append(1)
        return lru_scan_ref(a, b).to(a.dtype)

    monkeypatch.setattr(hybrid, "lru_scan", spy)
    dense, dense_last = hybrid.rglru_apply(p, u, impl="dense")
    # on the CPU "auto" is the chunked path, as the reference's off a TPU
    auto, _ = hybrid.rglru_apply(p, u)
    assert not calls and torch.equal(auto, dense)
    # "auto" where the tensors lie on the card: the kernel's wrapper
    monkeypatch.setattr(dispatch, "on_cpu", lambda *t: False)
    kern, kern_last = hybrid.rglru_apply(p, u)
    assert calls == [1]
    np.testing.assert_allclose(kern.numpy(), dense.numpy(), atol=1e-6,
                               rtol=1e-5)
    assert kern_last.dtype == torch.float32
    np.testing.assert_allclose(kern_last.numpy(), dense_last.numpy(),
                               atol=1e-6, rtol=1e-5)
    # ... but not with an initial state, nor for "dense"
    hybrid.rglru_apply(p, u, h0=torch.zeros(2, 64))
    hybrid.rglru_apply(p, u, impl="dense")
    assert calls == [1]
    # while autograd records, "pallas" raises and "auto" differentiates
    # through the chunked path
    pg = dict(p, w_a=p["w_a"].clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="queue 3, finding 5"):
        hybrid.rglru_apply(pg, u, impl="pallas")
    out, _ = hybrid.rglru_apply(pg, u)
    out.sum().backward()
    assert pg["w_a"].grad is not None and calls == [1]
    np.testing.assert_allclose(out.detach().numpy(), dense.numpy(), rtol=0,
                               atol=0)
    # the wrapper itself on a CUDA-marked call while autograd records
    # raises before it reaches the card
    with pytest.raises(NotImplementedError, match="queue 3, finding 5"):
        real(torch.zeros((1, 4, 8), requires_grad=True), torch.zeros(1, 4, 8))


# ---------------------------------------------------------------------------
# the model: schema, weights, prefill, loss, decode, serve
# ---------------------------------------------------------------------------

def test_full_size_schema_is_the_references():
    """72 leaf paths, in the reference's order (the tail a list), and the
    parameter count, at full size on the meta device."""
    j_cfg = j_get_config(ARCH)
    abstract = jax.eval_shape(
        lambda: j_transformer.init(jax.random.PRNGKey(0), j_cfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    want = ["/".join(str(p) for p in path) for path, _ in flat]
    cfg = get_config(ARCH)
    got = [transformer.path_str(p) for p in transformer._schema_paths(cfg)]
    assert len(got) == 72 and got == want
    assert "['tail']/[1]/['rec']/['w_x']" in got
    model = transformer.init(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(leaf.shape)) for _, leaf in flat) \
        == 10_444_984_320 == cfg.param_count() + 27 * 4096
    assert transformer.stack_plan(cfg) == (("rec", "rec", "attn"), 12,
                                           ("rec", "rec"))


def test_from_reference_carries_the_hybrid_tree():
    arrays, _ = _weights()
    _, cfg = _configs()
    model = transformer.from_reference(cfg, arrays, device="cpu")
    params = model.params()
    assert isinstance(params["tail"], list) and len(params["tail"]) == 1
    assert set(params["tail"][0]) == {"ln", "rec", "ln2", "mlp"}
    back = transformer.to_reference(model)
    assert set(back) == set(arrays) and len(back) == 57
    for name, want in arrays.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    # lambda stays float32 whatever param_dtype
    bf = transformer.init(dataclasses.replace(cfg, param_dtype="bfloat16"),
                          device="cpu").params()["tail"][0]["rec"]["lru"]
    assert bf["lambda"].dtype == torch.float32
    assert bf["w_a"].dtype == torch.bfloat16


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _np(buf):
    if isinstance(buf, torch.Tensor):
        return buf.float().numpy()
    return np.asarray(jnp.asarray(buf).astype(jnp.float32))


def _state_leaves(cache):
    """The cache as {path: numpy}, the reference's and the port's alike."""
    out = {f"{name}/{key}": _np(buf)
           for name, group in cache["groups"].items()
           for key, buf in group.items()}
    out.update({f"tail{i}/{key}": _np(buf)
                for i, group in enumerate(cache.get("tail", []))
                for key, buf in group.items()})
    return out


def _j_trajectory(compute, prompt, kv_len, steps):
    """The reference's greedy trajectory through its jitted
    ``decode_step``: inputs, logits and the states after each step."""
    j_cfg, _ = _configs(compute)
    _, params = _weights()
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    cache = j_transformer.init_cache(j_cfg, prompt.shape[0], kv_len)
    inputs, logits, states = [], [], []
    tok = prompt[:, :1]
    for t in range(steps):
        inputs.append(np.asarray(tok, np.int32))
        out, cache = step(params, cache, {"tokens": jnp.asarray(tok,
                                                                jnp.int32),
                                          "index": jnp.int32(t)})
        logits.append(np.asarray(out))
        states.append(_state_leaves(cache))
        tok = (prompt[:, t + 1:t + 2] if t + 1 < prompt.shape[1]
               else np.argmax(logits[-1], -1)[:, None])
    return inputs, logits, states


@functools.lru_cache(maxsize=None)
def _reference():
    """Float32 compute: the 20-step trajectory, the reference's
    ``make_serve_step`` loop's tokens, prefill and loss."""
    j_cfg, _ = _configs()
    _, params = _weights()
    prompt = np.random.RandomState(1).randint(0, j_cfg.vocab,
                                              size=(BATCH, PROMPT))
    inputs, logits, states = _j_trajectory("float32", prompt, KV_LEN, STEPS)
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
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    labels = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    prefill = jax.jit(functools.partial(j_transformer.prefill, cfg=j_cfg))
    loss = jax.jit(functools.partial(j_transformer.loss_fn, cfg=j_cfg))
    return {"prompt": prompt, "inputs": inputs, "logits": logits,
            "states": states, "served": np.stack(served, 1),
            "tokens": tokens, "labels": labels,
            "prefill": np.asarray(prefill(params, batch)),
            "loss": float(loss(params, batch))}


def _port_params(compute="float32"):
    _, t_cfg = _configs(compute)
    model = transformer.from_reference(t_cfg, _weights()[0], device="cpu")
    return t_cfg, model.params()


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


def test_prefill_bf16_within_the_references_bf16_distance():
    ref = _reference()
    j_cfg, cfg = _configs("bfloat16")
    _, j_params = _weights()
    batch = {"tokens": jnp.asarray(ref["tokens"], jnp.int32)}
    want = np.asarray(jax.jit(functools.partial(
        j_transformer.prefill, cfg=j_cfg))(j_params, batch))
    _, params = _port_params("bfloat16")
    got = make_prefill(cfg, device="cpu")(
        params, {"tokens": torch.from_numpy(ref["tokens"])}).numpy()
    rms = {name: float(np.sqrt(np.mean(np.square(e)))) for name, e in (
        ("vs_bf16", got - want), ("vs_f32", got - ref["prefill"]),
        ("noise", want - ref["prefill"]))}
    assert max(rms["vs_bf16"], rms["vs_f32"]) <= np.sqrt(2) * rms["noise"], \
        f"bf16 logits: RMS {rms}"


def test_decode_step_matches_reference_past_two_ring_wraps():
    ref = _reference()
    cfg, params = _port_params()
    cache = transformer.init_cache(cfg, BATCH, KV_LEN, device="cpu")
    kv = cache["groups"]["b2_attn"]["k"]
    assert kv.shape == (1, BATCH, 1, cfg.window, cfg.d_head)
    assert kv.dtype == torch.bfloat16
    assert cache["groups"]["b0_rec"]["conv"].shape == (1, BATCH, 3, 64)
    assert [tuple(t["h"].shape) for t in cache["tail"]] == [(1, BATCH, 64)]
    assert transformer.cache_batch_and_length(cache) == (BATCH, cfg.window)
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
            assert ((got.argmax(-1) == want.argmax(-1)) | tie).all(), \
                f"step {t}: greedy tokens differ"
            states = _state_leaves(cache)
            assert set(states) == set(ref["states"][t])
            for key, value in states.items():
                if key.endswith(("/k", "/v")):
                    np.testing.assert_allclose(
                        value, ref["states"][t][key], rtol=2.0 ** -7,
                        atol=1e-6, err_msg=f"step {t} {key}")
                else:
                    np.testing.assert_allclose(
                        value, ref["states"][t][key], rtol=0,
                        atol=LOGIT_TOL, err_msg=f"step {t} {key}")
    assert all(v == 0 for v in dispatch.launches.values())


def test_serve_step_on_a_window_long_cache_matches_reference():
    """The reference's ``test_sliding_window_cache_ring_buffer``: a cache
    of ``kv_len = window`` decoded for ``2·window + 3`` steps, through
    the port's ``ServeStep``, each step's logits against the
    reference's."""
    _, cfg = _configs()
    steps = 2 * cfg.window + 3
    _, want, _ = _j_trajectory("float32", np.ones((1, steps), np.int64),
                               cfg.window, steps)
    _, params = _port_params()
    step = make_serve_step(cfg, cfg.window, 1, device="cpu")
    got = []
    step.observe = lambda dbatch, logits: got.append(logits.numpy())
    cache = transformer.init_cache(cfg, 1, cfg.window, device="cpu")
    for t in range(steps):
        step(params, cache, {"tokens": torch.ones((1, 1), dtype=torch.int64),
                             "index": t})
    assert len(got) == steps and np.isfinite(got[-1]).all()
    for t in range(steps):
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {t}")
    # a cache of another length is refused
    with pytest.raises(ValueError, match="the step serves"):
        step(params, transformer.init_cache(cfg, 1, 4, device="cpu"),
             {"tokens": torch.ones((1, 1), dtype=torch.int64), "index": 0})


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


# ---------------------------------------------------------------------------
# attention at head dim 256 and the chunked path's window
# ---------------------------------------------------------------------------

def test_xla_chunked_attention_masks_the_window_as_the_reference():
    rng = np.random.RandomState(12)
    q = rng.randn(1, 4, 1024, 16).astype(np.float32)
    k = rng.randn(1, 1, 1024, 16).astype(np.float32)
    v = rng.randn(1, 1, 1024, 16).astype(np.float32)
    want = np.asarray(j_attention.xla_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=256))
    got = xla_chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True, window=256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    # the window binds: without it the output is another function
    full = xla_chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True)
    assert np.abs(full.numpy() - want).max() > 1e-2
    # and the dense plain version agrees with the chunked one
    dense = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=256)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4,
                               atol=2e-5)


def test_flash_plain_version_at_head_dim_256_mqa_window():
    rng = np.random.RandomState(13)
    q = rng.randn(1, 16, 64, 256).astype(np.float32)
    k = rng.randn(1, 1, 80, 256).astype(np.float32)
    v = rng.randn(1, 1, 80, 256).astype(np.float32)
    want = np.asarray(j_attention_ref(q, k, v, causal=True, window=16))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    # the CUDA wrapper takes D = 256 (the check a card call makes)
    flash_ops.check_inputs(*(torch.from_numpy(a) for a in (q, k, v)))
    with pytest.raises(ValueError, match="head dim 320"):
        flash_ops.check_inputs(torch.zeros(1, 16, 8, 320),
                               torch.zeros(1, 1, 8, 320),
                               torch.zeros(1, 1, 8, 320))


def test_decode_plain_version_at_group_16_head_dim_256():
    rng = np.random.RandomState(14)
    q = rng.randn(2, 16, 256).astype(np.float32)
    k = rng.randn(2, 1, 96, 256).astype(np.float32)
    v = rng.randn(2, 1, 96, 256).astype(np.float32)
    acc_j, m_j, l_j = j_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=70)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    acc, m, l = decode_attention_partial(tq, tk, tv, kv_len=70)
    for got, want in ((acc, acc_j), (m, m_j), (l, l_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # the split kernel's plan: a block holds group 16 × D 256 (teams of
    # 32 lanes, 4 rows each); recurrentgemma-9b's 8 (KV head, batch row)
    # pairs become 32 splits of 64 keys at kv_len 2,048, 256 blocks,
    # about two waves of 132 SMs
    assert fits_block(16, 256) and fits_block(1, 64)
    assert split_plan(8, 1, 2048, 16) == (32, 64)
    assert split_plan(2, 1, 70, 16) == (5, 16)
    decode_ops.check_inputs(tq, tk, tv, 70)
    # 32 rows × D 256 is past what a block holds
    assert not fits_block(32, 256)
    with pytest.raises(ValueError, match="group 32"):
        decode_ops.check_inputs(torch.zeros(1, 32, 256),
                                torch.zeros(1, 1, 8, 256),
                                torch.zeros(1, 1, 8, 256), 8)
