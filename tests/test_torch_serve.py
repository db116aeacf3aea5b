"""The port's serving path against the JAX package's: the flash and
decode attention kernels' plain versions, the decode step, prefill and
the greedy serve loop, on the CPU.

Inputs come from numpy seeds.  The reference's Pallas kernels run in
interpret mode, as its own tests run them on the CPU; the models carry
the reference's smoke weights (perturbed with numpy noise, so the zero
biases and unit norm scales matter) across by ``from_reference``, in
float32 compute with the reference's bfloat16 KV cache.

Tolerances and why:

* attention in float32: 2e-5 absolute and 1e-4 relative — the same
  sums in another order, and ``exp`` from another library; in bfloat16
  2e-2 (bf16's relative step is 2^-8 = 3.9e-3 and the output is rounded
  to it on both sides);
* decode partials: acc, m, l to 1e-5 relative and 1e-5 absolute;
* model logits (prefill and each decode step): 1e-4 absolute — logits
  of order 1 after 2 layers of float32 matmuls and the reference's
  division by sqrt(Dh) where the port multiplies by its inverse;
* bf16 caches: 2^-7 relative plus 1e-6 absolute: the same float32 key
  and value rounded to bf16 on both sides can land one bf16 step apart
  when the float32 values differ in their last bits near a rounding
  edge;
* greedy tokens: equal, except at a step where the reference's two
  largest logits lie within the logits' tolerance (a near-tie); a
  free-running loop is compared only up to its first near-tie, since
  the two loops feed different tokens after it.
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
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import \
    combine_partials as j_combine_partials
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.train import make_mesh_for_host
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention,
                                                  decode_attention_partial)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill
from repro_torch.models import transformer

LOGIT_TOL = 1e-4
PROMPT, GEN, BATCH = 4, 4, 2


def _qkv(seed, b, hq, hkv, sq, skv, d, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(dtype),
            rng.randn(b, hkv, skv, d).astype(dtype),
            rng.randn(b, hkv, skv, d).astype(dtype))


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# flash attention: the plain version against the Pallas kernel (interpret
# mode) and the reference's oracle
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (hq, hkv, sq, skv, causal, window, dtype)
    (4, 4, 128, 128, True, 0, "float32"),
    (8, 2, 128, 128, False, 0, "float32"),
    (8, 1, 64, 256, True, 64, "float32"),
    (8, 2, 128, 128, False, 64, "float32"),
    (4, 4, 128, 128, True, 0, "bfloat16"),
]


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,dtype", FLASH_CASES)
def test_flash_plain_version_matches_pallas_kernel(hq, hkv, sq, skv, causal,
                                                   window, dtype):
    q, k, v = _qkv(hq * sq + window, 1, hq, hkv, sq, skv, 32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
        interpret=True).astype(jnp.float32))
    oracle = np.asarray(j_attention_ref(jq, jk, jv, causal=causal,
                                        window=window))
    tq, tk, tv = (_to_torch(a, tdt) for a in (jq, jk, jv))
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(
            attention_ref(tq, tk, tv, causal=causal, window=window).numpy(),
            oracle, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 64)])
def test_flash_plain_version_takes_ragged_lengths(causal, window):
    # Sq % 8 and Skv % 128 != 0: the reference's wrapper sends these to
    # its oracle, the port's kernel masks the tails
    q, k, v = _qkv(7, 2, 8, 2, 100, 130, 32)
    want = np.asarray(j_attention_ref(q, k, v, causal=causal, window=window))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_flash_rows_that_see_no_key_are_zero():
    # causal with Sq > Skv: queries before the first key see nothing; the
    # CUDA kernel's l == 0 rule gives them 0 (the reference's oracle
    # averages v there)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 2, 12, 8, 16))
    out = attention_ref(q, k, v, causal=True)
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    want = np.asarray(j_attention_ref(q.numpy(), k.numpy(), v.numpy(),
                                      causal=True))
    np.testing.assert_allclose(out[:, :, 4:].numpy(), want[:, :, 4:],
                               rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# decode attention: plain version + combine against the Pallas kernel
# ---------------------------------------------------------------------------

def test_decode_plain_version_matches_pallas_kernel():
    rng = np.random.RandomState(11)
    q = rng.randn(2, 8, 32).astype(np.float32)
    k = rng.randn(2, 4, 256, 32).astype(np.float32)
    v = rng.randn(2, 4, 256, 32).astype(np.float32)
    kv_len = 200  # a ragged length: the second 128-key block half valid
    acc_j, m_j, l_j = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len,
        block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    acc, m, l = decode_attention_partial(tq, tk, tv, kv_len=kv_len)
    for got, want in ((acc, acc_j), (m, m_j), (l, l_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    want = np.asarray(j_combine_partials(acc_j[None], m_j[None], l_j[None]))
    got = decode_attention(tq, tk, tv, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(
        combine_partials(acc[None], m[None], l[None]).numpy(), want,
        rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# the models: decode step, prefill and the serve loop
# ---------------------------------------------------------------------------

ARCHS = ["qwen1.5-0.5b", "tinyllama-1.1b"]


def _configs(arch):
    return (dataclasses.replace(j_get_config(arch, smoke=True),
                                compute_dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype="float32"))


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's perturbed smoke weights, its greedy trajectory
    through its jitted ``decode_step`` (inputs, logits, final cache), its
    ``make_serve_step`` loop's tokens, and its prefill of the prompt."""
    j_cfg, _ = _configs(arch)
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {"/".join(str(p) for p in path): np.asarray(leaf)
              + rng.randn(*leaf.shape).astype(np.float32) * 0.05
              for path, leaf in flat}
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    prompt = np.random.RandomState(1).randint(0, j_cfg.vocab,
                                              size=(BATCH, PROMPT))
    kv_len = PROMPT + GEN
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    cache = j_transformer.init_cache(j_cfg, BATCH, kv_len)
    inputs, logits = [], []
    tok = prompt[:, :1]
    for t in range(kv_len):
        inputs.append(np.asarray(tok, np.int32))
        out, cache = step(params, cache, {"tokens": jnp.asarray(tok,
                                                                jnp.int32),
                                          "index": jnp.int32(t)})
        logits.append(np.asarray(out))
        tok = (prompt[:, t + 1:t + 2] if t + 1 < PROMPT
               else np.argmax(logits[-1], -1)[:, None])
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
    prefill = np.asarray(j_transformer.prefill(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)}, j_cfg))
    return {"arrays": arrays, "prompt": prompt, "inputs": inputs,
            "logits": logits,
            "cache": {k: np.asarray(v.astype(jnp.float32))
                      for k, v in cache["groups"]["b0_attn"].items()},
            "served": np.stack(served, 1), "prefill": prefill}


def _port_params(arch):
    _, t_cfg = _configs(arch)
    model = transformer.from_reference(t_cfg, _reference(arch)["arrays"],
                                       device="cpu")
    return t_cfg, model.params()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    ref = _reference(arch)
    cfg, params = _port_params(arch)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cpu")
    assert cache["groups"]["b0_attn"]["k"].dtype == torch.bfloat16
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
    assert all(v == 0 for v in dispatch.launches.values())
    for key in ("k", "v"):
        got = cache["groups"]["b0_attn"][key].float().numpy()
        np.testing.assert_allclose(got, ref["cache"][key], rtol=2.0 ** -7,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    ref = _reference(arch)
    cfg, params = _port_params(arch)
    got = make_prefill(cfg, device="cpu")(params, {"tokens": ref["prompt"]})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)
    # the two paths agree: decode steps over the prompt against a float32
    # cache end on the prefill's logits (the bf16 cache rounds k and v
    # first, which moves the logits by ~1e-2)
    cache = transformer.init_cache(cfg, BATCH, PROMPT, dtype=torch.float32,
                                   device="cpu")
    with torch.no_grad():
        for t in range(PROMPT):
            last, cache = transformer.decode_step(
                params, cache,
                {"tokens": torch.from_numpy(ref["prompt"][:, t:t + 1]),
                 "index": t}, cfg)
    np.testing.assert_allclose(last.numpy(), got.numpy(), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_serve_loop(arch):
    ref = _reference(arch)
    cfg, params = _port_params(arch)
    got = generate(cfg, params, ref["prompt"], GEN, device="cpu")["tokens"]
    want = ref["served"]
    assert got.shape == want.shape == (BATCH, GEN) and got.dtype == np.int32
    # the served tokens are the trajectory's inputs after the prompt
    np.testing.assert_array_equal(
        want, np.concatenate(ref["inputs"][PROMPT + 1:] +
                             [np.argmax(ref["logits"][-1], -1)[:, None]], 1))
    for t in range(GEN):
        # step PROMPT - 1 + t chose the token fed to step PROMPT + t
        if any((_top2_gap(ref["logits"][i]) <= LOGIT_TOL).any()
               for i in (PROMPT - 1 + t, PROMPT + t)):
            break  # a near-tie: the loops may part from here on
        np.testing.assert_array_equal(got[:, t], want[:, t],
                                      err_msg=f"generated token {t}")


# ---------------------------------------------------------------------------
# the attention entry point's rule
# ---------------------------------------------------------------------------

def test_attention_rule_keeps_autograd_off_the_flash_kernel():
    from repro_torch.models.attention import attention
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 4, 16, 16, 16))
    dense = attention(q, k, v, cfg, impl="dense")
    # without autograd "pallas" runs the flash wrapper (here its plain
    # version): the same function
    np.testing.assert_allclose(attention(q, k, v, cfg, impl="pallas").numpy(),
                               dense.numpy(), rtol=1e-6, atol=1e-6)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="queue 3, finding 1"):
        attention(qg, k, v, cfg, impl="pallas")
    # "auto" while autograd records takes the dense path and differentiates
    out = attention(qg, k, v, cfg)
    out.sum().backward()
    assert qg.grad is not None
    np.testing.assert_allclose(out.detach().numpy(), dense.numpy(), rtol=0,
                               atol=0)
    with torch.no_grad():
        attention(qg, k, v, cfg, impl="pallas")
