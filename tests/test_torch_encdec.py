"""The port's enc-dec family (whisper-large-v3) against the JAX package's:
the parameter tree, the encoder, the cross-attention's keys and values
and its cache, prefill, the decode step, the serve CLI's loop on a zero
encoder output, and the attention kernels' plain versions at the
cross-attention's shapes, on the CPU.

Inputs come from numpy seeds.  The reference's Pallas flash kernel runs
in interpret mode, as its own tests run it on the CPU; its model steps
run under ``jax.jit``.  The model carries the reference's smoke weights
(2 + 2 layers, d 64, enc_seq 16), each leaf perturbed with numpy noise
so the zero biases and unit layernorm scales matter, across by
``from_reference``, in float32 compute unless a test says bf16.

Tolerances and why:

* the encoder's states and the cross K/V: 1e-5 absolute — the same
  float32 function through 2 layers, sums in another order, ``exp``
  and ``tanh`` from another library;
* prefill and decode logits: 1e-4 absolute — logits of order 1 through
  2 + 2 layers; the reference divides scores by sqrt(Dh) where the port
  multiplies by its inverse;
* the bf16 self-attention cache: 2^-7 relative + 1e-6 absolute — the
  same float32 key and value rounded to bf16 on both sides can land one
  bf16 step apart near a rounding edge;
* greedy tokens: equal, except from a step where the reference's two
  largest logits lie within the logits' tolerance (a near-tie);
* attention's plain versions: 2e-5 absolute + 1e-4 relative (float32),
  the serving tests' (``tests/test_torch_serve.py``);
* bf16 compute: prefill logits within √2 times the distance (RMS over
  every logit) that bf16 compute puts between the reference's logits and
  its float32 logits, from both the reference's bf16 and float32 logits,
  as ``tests/test_torch_hybrid.py`` holds them: two bf16 evaluations
  that round at different places sit ~√2 σ apart.
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
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.launch.train import make_mesh_for_host
from repro.models import encdec as j_encdec
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill, make_serve_step
from repro_torch.models import encdec, transformer
from repro_torch.models.registry import ENCDEC_API, get_api

ARCH = "whisper-large-v3"
ENC_TOL, LOGIT_TOL = 1e-5, 1e-4
BATCH, PROMPT, GEN = 2, 3, 5   # 8 decode steps
SEQ = 6                        # prefill tokens


def _configs(compute="float32"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True),
                                compute_dtype=compute),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                compute_dtype=compute))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's smoke weights, each leaf perturbed by numpy noise;
    as numpy arrays by path and as the reference's tree."""
    j_cfg, _ = _configs()
    params = j_encdec.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {"/".join(str(p) for p in path): np.asarray(leaf)
              + rng.randn(*leaf.shape).astype(np.float32) * 0.05
              for path, leaf in flat}
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    return arrays, params


def _port_params(compute="float32"):
    _, cfg = _configs(compute)
    return cfg, encdec.from_reference(cfg, _weights()[0],
                                      device="cpu").params()


def _inputs():
    j_cfg, _ = _configs()
    rng = np.random.RandomState(3)
    frames = rng.randn(BATCH, j_cfg.enc_seq, j_cfg.d_model).astype(
        np.float32)
    tokens = rng.randint(0, j_cfg.vocab, size=(BATCH, SEQ))
    prompt = rng.randint(0, j_cfg.vocab, size=(BATCH, PROMPT))
    return frames, tokens, prompt


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's encoder states, cache, prefill logits and an
    8-step greedy trajectory through its jitted ``decode_step`` from the
    cache of the encoded frames; and its serve CLI's loop (zero encoder
    output) with that loop's logits."""
    j_cfg, _ = _configs()
    _, params = _weights()
    frames, tokens, prompt = _inputs()
    enc = jax.jit(functools.partial(j_encdec.encode, cfg=j_cfg))(
        params, jnp.asarray(frames))
    kv_len = PROMPT + GEN
    cache = j_encdec.init_cache(params, j_cfg, BATCH, kv_len, enc_out=enc)
    cross = {k: _np(v) for k, v in cache["cross"].items()}
    step = jax.jit(functools.partial(j_encdec.decode_step, cfg=j_cfg))

    def trajectory(cache):
        inputs, logits = [], []
        tok = prompt[:, :1]
        for t in range(kv_len):
            inputs.append(np.asarray(tok, np.int32))
            out, cache = step(params, cache,
                              {"tokens": jnp.asarray(tok, jnp.int32),
                               "index": jnp.int32(t)})
            logits.append(np.asarray(out))
            tok = (prompt[:, t + 1:t + 2] if t + 1 < PROMPT
                   else np.argmax(logits[-1], -1)[:, None])
        return inputs, logits, cache

    inputs, logits, cache = trajectory(cache)
    zero_inputs, zero_logits, _ = trajectory(
        j_encdec.init_cache(params, j_cfg, BATCH, kv_len))
    # the reference's own serve loop (repro/launch/serve.py::main)
    mesh = make_mesh_for_host(1)
    wrap, _, _ = j_make_serve_step(j_cfg, mesh, kv_len=kv_len, batch=BATCH)
    serve = wrap({"tokens": jax.ShapeDtypeStruct((BATCH, 1), jnp.int32),
                  "index": jax.ShapeDtypeStruct((), jnp.int32)})
    s_cache = j_encdec.init_cache(params, j_cfg, BATCH, kv_len)
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
    prefill = jax.jit(functools.partial(j_encdec.prefill, cfg=j_cfg))
    batch = {"frames": jnp.asarray(frames),
             "tokens": jnp.asarray(tokens, jnp.int32)}
    return {"enc": _np(enc), "cross": cross, "inputs": inputs,
            "logits": logits, "self": {k: _np(cache[k]) for k in "kv"},
            "zero_logits": zero_logits, "served": np.stack(served, 1),
            "prefill": np.asarray(prefill(params, batch))}


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_schema_is_the_references(smoke):
    """Leaf paths and shapes equal the reference's (full size through
    ``jax.eval_shape`` and the meta device: nothing allocated)."""
    j_cfg, cfg = j_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke)
    abstract = jax.eval_shape(lambda: j_encdec.init(jax.random.PRNGKey(0),
                                                    j_cfg))
    want = {"/".join(str(p) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                abstract)[0]}
    model = get_api(cfg).init(cfg, device="meta")
    got = {path_str(p): tuple(leaf.shape)
           for p, leaf in flatten_with_path(model.params())}
    assert got == want
    assert got["['dec_pos']"] == (encdec.MAX_DEC_LEN, cfg.d_model)
    assert get_api(cfg) is ENCDEC_API and isinstance(model, encdec.EncDec)
    if not smoke:
        assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
                cfg.enc_seq, cfg.vocab) == (32, 32, 1280, 20, 1500, 51866)
        assert cfg.param_count() == 1_534_558_720


def test_from_reference_round_trips():
    arrays, _ = _weights()
    _, cfg = _configs()
    back = encdec.to_reference(encdec.from_reference(cfg, arrays,
                                                     device="cpu"))
    assert set(back) == set(arrays)
    for name, want in arrays.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    with pytest.raises(ValueError, match="leaf paths differ"):
        encdec.from_reference(cfg, {k: v for k, v in arrays.items()
                                    if "dec_pos" not in k}, device="cpu")


# ---------------------------------------------------------------------------
# encoder, cross K/V, prefill
# ---------------------------------------------------------------------------

def test_encoder_and_cross_cache_match_reference():
    ref = _reference()
    cfg, params = _port_params()
    frames, _, _ = _inputs()
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(frames), cfg)
        np.testing.assert_allclose(enc.numpy(), ref["enc"], rtol=0,
                                   atol=ENC_TOL)
        layer0 = {k: v[0] for k, v in params["dec_layers"]["cross"].items()}
        kv = encdec.cross_kv(layer0, enc, cfg)
        cache = get_api(cfg).init_cache(params, cfg, BATCH, PROMPT + GEN,
                                        enc_out=enc)
    for key in ("k", "v"):
        np.testing.assert_allclose(kv[key].numpy(), ref["cross"][key][0],
                                   rtol=0, atol=ENC_TOL, err_msg=key)
        got = cache["cross"][key]
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (cfg.n_layers, BATCH, cfg.n_heads,
                                    cfg.enc_seq, cfg.d_head)
        np.testing.assert_allclose(got.numpy(), ref["cross"][key], rtol=0,
                                   atol=ENC_TOL, err_msg=key)
        assert cache[key].dtype == torch.bfloat16
    assert transformer.cache_batch_and_length(cache) == (BATCH, PROMPT + GEN)
    # the encoder positions are the reference's bits
    np.testing.assert_array_equal(
        encdec.sinusoidal_positions(50, 64).numpy(),
        np.asarray(j_encdec.sinusoidal_positions(50, 64)))


def test_prefill_matches_reference():
    ref = _reference()
    cfg, params = _port_params()
    frames, tokens, _ = _inputs()
    got = make_prefill(cfg, device="cpu")(params, {"frames": frames,
                                                   "tokens": tokens})
    assert got.dtype == torch.float32 and got.shape == (BATCH, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)


def test_prefill_bf16_within_the_references_bf16_distance():
    ref = _reference()
    j_cfg, cfg = _configs("bfloat16")
    _, j_params = _weights()
    frames, tokens, _ = _inputs()
    want = np.asarray(jax.jit(functools.partial(
        j_encdec.prefill, cfg=j_cfg))(j_params, {
            "frames": jnp.asarray(frames),
            "tokens": jnp.asarray(tokens, jnp.int32)}))
    _, params = _port_params("bfloat16")
    got = make_prefill(cfg, device="cpu")(
        params, {"frames": frames, "tokens": tokens}).numpy()
    rms = {name: float(np.sqrt(np.mean(np.square(e)))) for name, e in (
        ("vs_bf16", got - want), ("vs_f32", got - ref["prefill"]),
        ("noise", want - ref["prefill"]))}
    assert max(rms["vs_bf16"], rms["vs_f32"]) <= np.sqrt(2) * rms["noise"], \
        f"bf16 logits: RMS {rms}"


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------

def test_decode_steps_match_reference():
    ref = _reference()
    cfg, params = _port_params()
    frames, _, _ = _inputs()
    dispatch.reset_launches()
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(frames), cfg)
        cache = encdec.init_cache(params, cfg, BATCH, PROMPT + GEN,
                                  enc_out=enc)
        for t, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
            logits, cache = encdec.decode_step(
                params, cache, {"tokens": torch.from_numpy(tok), "index": t},
                cfg)
            got = logits.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"step {t}")
            tie = _top2_gap(want) <= LOGIT_TOL
            assert ((got.argmax(-1) == want.argmax(-1)) | tie).all(), \
                f"step {t}: greedy tokens differ"
    assert all(v == 0 for v in dispatch.launches.values())
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   ref["self"][key], rtol=2.0 ** -7,
                                   atol=1e-6, err_msg=key)


def test_serve_cli_loop_matches_reference_on_a_zero_encoder_output():
    """The reference's CLI serves from the cross K/V of zeros
    (``init_cache`` without ``enc_out``); so do the port's ``generate``
    and ``make_serve_step``."""
    ref = _reference()
    cfg, params = _port_params()
    _, _, prompt = _inputs()
    got = generate(cfg, params, prompt, GEN, device="cpu")
    assert got["tokens"].shape == (BATCH, GEN)
    assert got["cache"]["cross"]["k"].dtype == torch.bfloat16
    want = ref["served"]
    for t in range(GEN):
        if any((_top2_gap(ref["zero_logits"][i]) <= LOGIT_TOL).any()
               for i in (PROMPT - 1 + t, PROMPT + t)):
            break  # a near-tie: the loops may part from here on
        np.testing.assert_array_equal(got["tokens"][:, t], want[:, t],
                                      err_msg=f"generated token {t}")
    # the step refuses a cache of another length
    step = make_serve_step(cfg, PROMPT + GEN, BATCH, device="cpu")
    with pytest.raises(ValueError, match="the step serves"):
        step(params, encdec.init_cache(params, cfg, BATCH, 4),
             {"tokens": torch.zeros((BATCH, 1), dtype=torch.int64),
              "index": 0})


# ---------------------------------------------------------------------------
# attention's plain versions at the cross-attention's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv", [(64, 192), (128, 64)])
def test_flash_plain_version_non_causal_sq_neq_skv(sq, skv):
    rng = np.random.RandomState(sq + skv)
    q = rng.randn(1, 4, sq, 32).astype(np.float32)
    k = rng.randn(1, 4, skv, 32).astype(np.float32)
    v = rng.randn(1, 4, skv, 32).astype(np.float32)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        block_q=64, block_k=64, interpret=True))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_cross_attention_step_matches_the_references_one_row():
    """The decode step's cross-attention (the decode kernel's plain
    version at ``kv_len = enc_seq``) against the reference's
    ``_cross_attn`` of one query row, at a ragged 300 encoder frames."""
    j_cfg, cfg = _configs()
    _, j_params = _weights()
    _, params = _port_params()
    rng = np.random.RandomState(9)
    x = rng.randn(BATCH, cfg.d_model).astype(np.float32)
    enc = rng.randn(BATCH, 300, cfg.d_model).astype(np.float32)
    j_p = jax.tree_util.tree_map(lambda a: a[1],
                                 j_params["dec_layers"]["cross"])
    j_kv = j_encdec.cross_kv(j_p, jnp.asarray(enc), j_cfg)
    want = np.asarray(j_encdec._cross_attn(j_p, jnp.asarray(x)[:, None],
                                           j_kv, j_cfg))[:, 0]
    p = {k: v[1] for k, v in params["dec_layers"]["cross"].items()}
    with torch.no_grad():
        kv = encdec.cross_kv(p, torch.from_numpy(enc), cfg)
        got = encdec._cross_attn_step(p, torch.from_numpy(x), kv["k"],
                                      kv["v"], cfg, "auto")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)
