"""The port's dense-block variants against the JAX package's:
starcoder2-3b (layernorm, the biased gelu MLP, qkv bias and a sliding
window over a ring-buffer KV cache) and qwen2-vl-2b (the embeddings
frontend: prefill and decode fed ``embeds`` in place of tokens), on the
CPU.

Inputs come from numpy seeds.  The reference's model steps run under
``jax.jit``.  The models carry the reference's smoke weights (2 layers,
d 64; starcoder2-3b's window 8), each leaf perturbed with numpy noise so
the zero biases and unit layernorm scales matter, across by
``from_reference``, in float32 compute unless a test says bf16.

Tolerances and why:

* layernorm and the gelu MLP in float32: 1e-6 absolute + 1e-5 relative
  — the same float32 statistics and matmuls; ``tanh`` from another
  library;
* model logits (prefill and each decode step): 1e-4 absolute — logits
  of order 1 through 2 layers, sums in another order; the reference
  divides scores by sqrt(Dh) where the port multiplies by its inverse;
* the bf16 KV cache: 2^-7 relative + 1e-6 absolute — the same float32
  key and value rounded to bf16 on both sides can land one bf16 step
  apart near a rounding edge;
* greedy tokens: equal, except at a step where the reference's two
  largest logits lie within the logits' tolerance (a near-tie);
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

from repro.configs import get_config as j_get_config
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.kernels import dispatch
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import make_prefill
from repro_torch.models import layers, transformer

STARCODER, VLM = "starcoder2-3b", "qwen2-vl-2b"
LOGIT_TOL = 1e-4
BATCH = 2
SEQ = 24                     # prefill length: the window of 8 binds
KV_LEN, STEPS = 32, 24       # a ring of min(32, 8) = 8 slots wraps twice
VLM_PROMPT, VLM_GEN = 4, 4


def _configs(arch, compute="float32"):
    return (dataclasses.replace(j_get_config(arch, smoke=True),
                                compute_dtype=compute),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=compute))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's smoke weights, each leaf perturbed by numpy noise."""
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
    return arrays, params


def _port_params(arch, compute="float32"):
    _, cfg = _configs(arch, compute)
    return cfg, transformer.from_reference(cfg, _weights(arch)[0],
                                           device="cpu").params()


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _prefill_batch(arch, framework):
    """starcoder2-3b: tokens ``[B, SEQ]``; qwen2-vl-2b: embeds
    ``[B, SEQ, d]``."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.RandomState(2)
    if cfg.frontend == "embeddings":
        e = rng.randn(BATCH, SEQ, cfg.d_model).astype(np.float32)
        return {"embeds": jnp.asarray(e) if framework == "jax" else e}
    t = rng.randint(0, cfg.vocab, size=(BATCH, SEQ))
    return {"tokens": jnp.asarray(t, jnp.int32) if framework == "jax"
            else t}


@functools.lru_cache(maxsize=None)
def _j_prefill(arch, compute):
    j_cfg, _ = _configs(arch, compute)
    return np.asarray(jax.jit(functools.partial(
        j_transformer.prefill, cfg=j_cfg))(_weights(arch)[1],
                                           _prefill_batch(arch, "jax")))


# ---------------------------------------------------------------------------
# the configs and the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [STARCODER, VLM, "whisper-large-v3"])
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_are_the_references(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(j_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", [STARCODER, VLM, "whisper-large-v3"])
def test_serve_cli_prints_the_references_line(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3", "--device",
                       "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("generated (2, 3) tokens; ") and \
        " tok/s; sample row: [" in line, line


# ---------------------------------------------------------------------------
# the blocks: layernorm, the biased gelu MLP, the parameter tree
# ---------------------------------------------------------------------------

def test_layernorm_and_gelu_mlp_match_reference():
    j_cfg, cfg = _configs(STARCODER)
    arrays, j_params = _weights(STARCODER)
    rng = np.random.RandomState(5)
    x = (rng.randn(BATCH, 7, cfg.d_model) * 3 + 1).astype(np.float32)
    j_ln = jax.tree_util.tree_map(lambda a: a[0],
                                  j_params["layers"]["b0_attn"]["ln1"])
    want = np.asarray(j_layers.apply_norm(j_cfg, j_ln, jnp.asarray(x)))
    ln = {k: torch.from_numpy(np.array(v)) for k, v in j_ln.items()}
    got = layers.apply_norm(cfg, ln, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    j_mlp = jax.tree_util.tree_map(lambda a: a[0],
                                   j_params["layers"]["b0_attn"]["mlp"])
    assert sorted(j_mlp) == ["b_down", "b_up", "w_down", "w_up"]
    want = np.asarray(j_layers.mlp_apply(j_mlp, jnp.asarray(x), j_cfg))
    mlp = {k: torch.from_numpy(np.array(v)) for k, v in j_mlp.items()}
    got = layers.mlp_apply(mlp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", [STARCODER, VLM])
@pytest.mark.parametrize("smoke", [True, False])
def test_schema_is_the_references(arch, smoke):
    """Leaf paths and shapes equal the reference's (full size through
    ``jax.eval_shape`` and the meta device), and the weights carry
    across and back unchanged."""
    j_cfg, cfg = j_get_config(arch, smoke=smoke), get_config(arch, smoke)
    abstract = jax.eval_shape(
        lambda: j_transformer.init(jax.random.PRNGKey(0), j_cfg))
    want = {"/".join(str(p) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                abstract)[0]}
    got = {path_str(p): tuple(leaf.shape) for p, leaf in flatten_with_path(
        transformer.init(cfg, device="meta").params())}
    assert got == want
    if smoke:
        arrays, _ = _weights(arch)
        back = transformer.to_reference(transformer.from_reference(
            _configs(arch)[1], arrays, device="cpu"))
        for name, value in arrays.items():
            np.testing.assert_array_equal(back[name], value, err_msg=name)
    else:
        assert cfg.param_count() == {STARCODER: 3_180_515_328,
                                     VLM: 1_543_655_424}[arch]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [STARCODER, VLM])
def test_prefill_matches_reference(arch):
    cfg, params = _port_params(arch)
    got = make_prefill(cfg, device="cpu")(params,
                                          _prefill_batch(arch, "numpy"))
    assert got.dtype == torch.float32 and got.shape == (BATCH, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _j_prefill(arch, "float32"),
                               rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", [STARCODER, VLM])
def test_prefill_bf16_within_the_references_bf16_distance(arch):
    want, want32 = _j_prefill(arch, "bfloat16"), _j_prefill(arch, "float32")
    cfg, params = _port_params(arch, "bfloat16")
    got = make_prefill(cfg, device="cpu")(
        params, _prefill_batch(arch, "numpy")).numpy()
    rms = {name: float(np.sqrt(np.mean(np.square(e)))) for name, e in (
        ("vs_bf16", got - want), ("vs_f32", got - want32),
        ("noise", want - want32))}
    assert max(rms["vs_bf16"], rms["vs_f32"]) <= np.sqrt(2) * rms["noise"], \
        f"bf16 logits: RMS {rms}"


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_starcoder2_decode_matches_reference_past_two_ring_wraps():
    """24 greedy steps against a cache of ``min(32, window 8)`` slots, the
    window masking keys on both sides of the ring, each step's logits and
    the final cache against the reference's."""
    j_cfg, cfg = _configs(STARCODER)
    _, j_params = _weights(STARCODER)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, size=(BATCH, 4))
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    j_cache = j_transformer.init_cache(j_cfg, BATCH, KV_LEN)
    _, params = _port_params(STARCODER)
    cache = transformer.init_cache(cfg, BATCH, KV_LEN, device="cpu")
    assert transformer.cache_batch_and_length(cache) == (BATCH, cfg.window)
    dispatch.reset_launches()
    tok = prompt[:, :1]
    with torch.no_grad():
        for t in range(STEPS):
            want, j_cache = step(j_params, j_cache,
                                 {"tokens": jnp.asarray(tok, jnp.int32),
                                  "index": jnp.int32(t)})
            want = np.asarray(want)
            logits, cache = transformer.decode_step(
                params, cache, {"tokens": torch.from_numpy(tok), "index": t},
                cfg)
            got = logits.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"step {t}")
            tie = _top2_gap(want) <= LOGIT_TOL
            assert ((got.argmax(-1) == want.argmax(-1)) | tie).all(), \
                f"step {t}: greedy tokens differ"
            tok = (prompt[:, t + 1:t + 2] if t + 1 < prompt.shape[1]
                   else want.argmax(-1)[:, None])
    assert all(v == 0 for v in dispatch.launches.values())
    for key in ("k", "v"):
        np.testing.assert_allclose(
            cache["groups"]["b0_attn"][key].float().numpy(),
            np.asarray(j_cache["groups"]["b0_attn"][key].astype(
                jnp.float32)), rtol=2.0 ** -7, atol=1e-6, err_msg=key)


def test_vlm_decode_from_embeds_matches_reference():
    """The serve loop fed embeds (``generate(..., embeds=)``), each
    step's logits against the reference's ``decode_step`` fed the same
    embeds; the CLI's zero embeds give the reference's zero tokens."""
    j_cfg, cfg = _configs(VLM)
    _, j_params = _weights(VLM)
    kv_len = VLM_PROMPT + VLM_GEN
    embeds = np.random.RandomState(4).randn(BATCH, kv_len, cfg.d_model
                                            ).astype(np.float32)
    step = jax.jit(functools.partial(j_transformer.decode_step, cfg=j_cfg))
    j_cache = j_transformer.init_cache(j_cfg, BATCH, kv_len)
    want = []
    for t in range(kv_len):
        out, j_cache = step(j_params, j_cache,
                            {"embeds": jnp.asarray(embeds[:, t:t + 1]),
                             "index": jnp.int32(t)})
        want.append(np.asarray(out))
    _, params = _port_params(VLM)
    got = []
    prompt = np.zeros((BATCH, VLM_PROMPT), np.int64)
    res = generate(cfg, params, prompt, VLM_GEN, device="cpu",
                   embeds=torch.from_numpy(embeds),
                   observe=lambda dbatch, logits: got.append(logits.numpy()))
    assert len(got) == kv_len and res["tokens"].shape == (BATCH, VLM_GEN)
    for t in range(kv_len):
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {t}")
    np.testing.assert_array_equal(
        res["tokens"], np.stack([w.argmax(-1) for w in want[VLM_PROMPT:]], 1))
    # the decode path ends on prefill over the same embeds (float32 cache)
    cache = transformer.init_cache(cfg, BATCH, kv_len, dtype=torch.float32,
                                   device="cpu")
    with torch.no_grad():
        for t in range(kv_len):
            last, cache = transformer.decode_step(
                params, cache, {"embeds": torch.from_numpy(
                    embeds[:, t:t + 1]), "index": t}, cfg)
    pre = make_prefill(cfg, device="cpu")(params, {"embeds": embeds})
    np.testing.assert_allclose(last.numpy(), pre.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    zero = generate(cfg, params, prompt, VLM_GEN, device="cpu")["tokens"]
    assert zero.shape == (BATCH, VLM_GEN)
