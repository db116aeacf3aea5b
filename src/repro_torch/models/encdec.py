"""Whisper-style encoder-decoder (conv frontend stubbed), as an
``nn.Module``.

Counterpart of ``repro/models/encdec.py`` (whisper-large-v3).  The
batch carries *post-conv* frame embeddings ``frames`` ``[B, enc_seq,
d]``, as the reference's: the two strided conv1d layers of Whisper's
frontend are a stub in both packages.  Downstream: sinusoidal encoder
positions, bidirectional encoder self-attention, learned decoder
positions (``dec_pos``, ``MAX_DEC_LEN`` rows), causal decoder
self-attention and cross-attention, biased gelu MLPs, pre-LN layernorm
with bias, and the decoder embedding tied to the LM head.

* ``init(cfg, seed, device)`` — an ``EncDec`` with the reference's tree
  (``embed``, ``dec_pos``, stacked ``enc_layers`` ``{ln1, attn, ln2,
  mlp}``, ``enc_norm``, stacked ``dec_layers`` ``{ln1, self, ln_x,
  cross, ln2, mlp}``, ``dec_norm``), every leaf under ``*_layers`` with
  a leading ``L`` dim;
* ``from_reference`` / ``to_reference`` — the reference's parameter
  tree as numpy arrays keyed by its leaf paths;
* ``encode``, ``cross_kv``, ``decode_hidden``, ``loss_fn`` and
  ``prefill`` — the encoder's and the cross-attention's attention runs
  ``attention(causal=False)``: the flash kernel on the card;
* ``init_cache(params, cfg, batch, kv_len, enc_out=None)`` — the
  self-attention cache ``k``, ``v`` ``[L, B, H, kv_len, Dh]`` (bf16)
  and ``cross`` ``{k, v: [L, B, H, enc_seq, Dh]}``, the encoder
  output's keys and values, of its dtype; without ``enc_out``, those of
  zeros, as the reference's serve CLI takes them;
* ``decode_step`` — one greedy step: the self-attention through
  ``transformer._decode_attn_block`` and the one-row cross-attention
  against ``cache["cross"]`` through the decode kernel at ``kv_len =
  enc_seq`` (the reference runs it through its flash entry with one
  query row; it is the same softmax over every encoder key), the
  self-attention cache updated in place.

Training (``remat``, MPC-FSDP) is a later slice: ``launch/steps.py``
refuses it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path, unflatten
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention,
                                                  decode_attention_ref)
from .attention import attention
from .common import ArchConfig, dtype_of, shard
from .layers import (apply_norm, chunked_softmax_xent, embed, embedding_init,
                     mlp_apply, mlp_init, norm_init, sinusoidal_positions)
from .transformer import (CACHE_DTYPE, ParamTree, _decode_attn_block,
                          _model_device, attn_apply, attn_init, generator,
                          load_tree, stacked_layers, to_reference)

#: learned decoder positions sized for the largest decode cell (32k), as
#: the reference's; whisper's real 448-token table is a special case
MAX_DEC_LEN = 32768 + 8

__all__ = ["EncDec", "MAX_DEC_LEN", "cross_kv", "decode_hidden",
           "decode_step", "encode", "from_reference", "init", "init_cache",
           "loss_fn", "prefill", "to_reference"]


def check_family(cfg: ArchConfig) -> None:
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name} is not an enc-dec config: "
                         "models/transformer.py runs it")


class EncDec(ParamTree):
    """An encoder-decoder whose parameters sit under the reference's tree
    keys (``enc_layers.attn.wq`` [L, d, h·dh], ``dec_layers.cross.wk``,
    ``dec_pos``, ...)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        check_family(cfg)
        super().__init__(cfg, tree)


def _enc_block_init(gen, cfg, dtype, device):
    return {"ln1": norm_init(cfg, dtype, device),
            "attn": attn_init(gen, cfg, dtype, device),
            "ln2": norm_init(cfg, dtype, device),
            "mlp": mlp_init(gen, cfg, dtype, device)}


def _dec_block_init(gen, cfg, dtype, device):
    return {"ln1": norm_init(cfg, dtype, device),
            "self": attn_init(gen, cfg, dtype, device),
            "ln_x": norm_init(cfg, dtype, device),
            "cross": attn_init(gen, cfg, dtype, device),
            "ln2": norm_init(cfg, dtype, device),
            "mlp": mlp_init(gen, cfg, dtype, device)}


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> EncDec:
    """An ``EncDec`` with weights drawn from ``seed`` on ``device``, with
    the reference's scales (embedding 0.02, ``dec_pos`` 0.01,
    projections ``1/sqrt(fan_in)``, norm scales 1, biases 0)."""
    check_family(cfg)
    device = _model_device(device)
    dtype = dtype_of(cfg, "param_dtype")
    gen = generator(device, seed)
    tree: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "dec_pos": torch.randn((MAX_DEC_LEN, cfg.d_model), generator=gen,
                               dtype=dtype, device=device) * 0.01,
        "enc_layers": stacked_layers(
            cfg.n_enc_layers,
            lambda: _enc_block_init(gen, cfg, dtype, device), device),
        "enc_norm": norm_init(cfg, dtype, device),
        "dec_layers": stacked_layers(
            cfg.n_layers, lambda: _dec_block_init(gen, cfg, dtype, device),
            device),
        "dec_norm": norm_init(cfg, dtype, device),
    }
    return EncDec(cfg, tree)


def _schema_paths(cfg: ArchConfig):
    """Leaf paths of the model ``init(cfg)`` builds (on the meta device:
    no memory, no weights)."""
    return [p for p, _ in flatten_with_path(init(cfg, device="meta")
                                            .params())]


def from_reference(cfg: ArchConfig, arrays: dict[str, np.ndarray],
                   device="cuda") -> EncDec:
    """The port's model holding the reference's weights (``arrays``: each
    leaf path as the reference prints it, ``"['dec_layers']/['cross']/
    ['wk']"``, to its numpy array)."""
    return load_tree(EncDec, cfg, arrays, _schema_paths(cfg), device)


def _per_layer(stack):
    """The layers of a stacked tree, one tree each (``unbind`` of every
    leaf, once)."""
    flat = flatten_with_path(stack)
    paths = [p for p, _ in flat]
    for leaves in zip(*(leaf.unbind(0) for _, leaf in flat)):
        yield unflatten(paths, leaves)


# ---------------------------------------------------------------------------
# Encoder, cross-attention, decoder
# ---------------------------------------------------------------------------

def _cross_attn(p, x, enc_kv, cfg: ArchConfig, impl: str = "auto"):
    """x: ``[B, Sq, d]`` queries; enc_kv: ``{k, v: [B, H, Se, Dh]}``."""
    b, sq, _ = x.shape
    cd = x.dtype
    h, dh = cfg.n_heads, cfg.d_head
    q = (x @ p["wq"].to(cd)).reshape(b, sq, h, dh).transpose(1, 2)
    q = shard(q, "batch", "heads", None, None)
    o = attention(q, enc_kv["k"].to(cd), enc_kv["v"].to(cd), cfg,
                  causal=False, impl=impl)
    o = o.transpose(1, 2).reshape(b, sq, h * dh)
    return o @ p["wo"].to(cd)


def cross_kv(p, enc_out, cfg: ArchConfig):
    """The cross-attention's keys and values of ``enc_out`` ``[B, Se, d]``,
    ``{k, v: [B, H, Se, Dh]}`` in its dtype."""
    b, se, _ = enc_out.shape
    cd = enc_out.dtype
    h, dh = cfg.n_heads, cfg.d_head
    k = (enc_out @ p["wk"].to(cd)).reshape(b, se, h, dh)
    v = (enc_out @ p["wv"].to(cd)).reshape(b, se, h, dh)
    return {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}


def encode(params, frames, cfg: ArchConfig, impl: str = "auto"):
    """frames: ``[B, Se, d]`` post-conv embeddings -> encoder states (the
    compute dtype)."""
    cd = dtype_of(cfg, "compute_dtype")
    b, se, _ = frames.shape
    x = frames.to(cd) + sinusoidal_positions(se, cfg.d_model).to(
        device=frames.device, dtype=cd)[None]
    x = shard(x, "batch", "seq", "embed")
    pos = torch.arange(se, device=x.device).expand(b, se)
    for lp in _per_layer(params["enc_layers"]):
        h = x + attn_apply(lp["attn"], apply_norm(cfg, lp["ln1"], x), cfg,
                           pos, impl=impl, causal=False)
        x = h + mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], h), cfg)
    return apply_norm(cfg, params["enc_norm"], x)


def decode_hidden(params, tokens, enc_out, cfg: ArchConfig, positions=None,
                  impl: str = "auto"):
    """The decoder's final hidden states ``[B, S, d]`` over ``tokens``
    ``[B, S]`` against the encoder states ``enc_out``."""
    cd = dtype_of(cfg, "compute_dtype")
    b, s = tokens.shape
    x = embed(params["embed"], tokens, cd)
    x = x + params["dec_pos"][:s].to(cd)[None]
    x = shard(x, "batch", "seq", "embed")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    for lp in _per_layer(params["dec_layers"]):
        h = x + attn_apply(lp["self"], apply_norm(cfg, lp["ln1"], x), cfg,
                           positions, impl=impl, causal=True)
        kv = cross_kv(lp["cross"], enc_out, cfg)
        h = h + _cross_attn(lp["cross"], apply_norm(cfg, lp["ln_x"], h), kv,
                            cfg, impl=impl)
        x = h + mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], h), cfg)
    return apply_norm(cfg, params["dec_norm"], x)


def loss_fn(params, batch, cfg: ArchConfig, impl: str = "auto"):
    """Mean next-token NLL.  batch: frames ``[B, Se, d]``, tokens
    ``[B, S]``, labels ``[B, S]``."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    h = decode_hidden(params, batch["tokens"], enc_out, cfg, impl=impl)
    w = params["embed"]["table"].T
    return chunked_softmax_xent(h, w, batch["labels"],
                                label_mask=batch.get("label_mask"))


def prefill(params, batch, cfg: ArchConfig, impl: str = "auto"):
    """Last-position logits ``[B, V]`` (float32): the encoder over
    ``batch["frames"]``, the decoder over ``batch["tokens"]``.  Builds no
    cache, as the reference's."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    h = decode_hidden(params, batch["tokens"], enc_out, cfg, impl=impl)
    last = h[:, -1, :]
    w = params["embed"]["table"].T
    return (last @ w.to(last.dtype)).float()


# ---------------------------------------------------------------------------
# Decode with a self-attention KV cache and the encoder's cross K/V
# ---------------------------------------------------------------------------

def init_cache(params, cfg: ArchConfig, batch: int, kv_len: int,
               enc_out=None, dtype=CACHE_DTYPE, device=None):
    """``{"k", "v": [L, B, Hkv, kv_len, Dh]}`` zeros of ``dtype`` and
    ``"cross": {"k", "v": [L, B, H, Se, Dh]}``, each layer's
    ``cross_kv`` of ``enc_out`` ``[B, Se, d]`` (zeros ``[B, enc_seq, d]``
    of ``dtype`` without it, as the reference's), on the parameters'
    device unless ``device=`` says."""
    check_family(cfg)
    table = params["embed"]["table"]
    device = table.device if device is None else _model_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, kv_len, cfg.d_head)
    cache: dict[str, Any] = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}
    if enc_out is None:
        enc_out = torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                              device=device)
    cross = None
    with torch.no_grad():
        for layer, lp in enumerate(_per_layer(params["dec_layers"])):
            kv = cross_kv(lp["cross"], enc_out, cfg)
            if cross is None:
                cross = {key: torch.empty((cfg.n_layers,) + tuple(t.shape),
                                          dtype=t.dtype, device=device)
                         for key, t in kv.items()}
            for key, t in kv.items():
                cross[key][layer].copy_(t)
    cache["cross"] = cross
    return cache


def _cross_attn_step(p, x, k, v, cfg: ArchConfig, impl: str):
    """One query row ``x`` ``[B, d]`` against every encoder key of the
    cross cache ``k``, ``v`` ``[B, H, Se, Dh]``: the decode kernel at
    ``kv_len = Se`` (``impl="dense"``: its plain version)."""
    b = x.shape[0]
    cd = x.dtype
    h, dh = cfg.n_heads, cfg.d_head
    q = (x @ p["wq"].to(cd)).reshape(b, h, dh)
    # the reference casts the cache to the compute dtype first
    k, v = k.to(cd), v.to(cd)
    if impl == "dense":
        acc, m, l = decode_attention_ref(q, k, v, kv_len=k.shape[2])
        o = combine_partials(acc[None], m[None], l[None]).to(cd)
    else:
        o = decode_attention(q, k, v, kv_len=k.shape[2])
    return o.reshape(b, h * dh) @ p["wo"].to(cd)


def decode_step(params, cache, batch, cfg: ArchConfig, impl: str = "auto"):
    """One decode step.  batch: ``tokens`` ``[B, 1]``, ``index`` (a host
    int: the current absolute position).  Returns (logits ``[B, V]``
    float32, the cache, its self-attention ``k``, ``v`` updated in
    place).  ``impl``: ``"auto"`` runs the decode-attention wrapper (the
    CUDA kernel on the card), ``"dense"`` its plain version."""
    check_family(cfg)
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown decode impl {impl!r}: auto or dense")
    cd = dtype_of(cfg, "compute_dtype")
    index = int(batch["index"])
    x = embed(params["embed"], batch["tokens"][:, 0], cd)
    x = x + params["dec_pos"][index].to(cd)[None]
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int64,
                           device=x.device)
    for layer, lp in enumerate(_per_layer(params["dec_layers"])):
        kv = {"k": cache["k"][layer], "v": cache["v"][layer]}
        h = x + _decode_attn_block(lp["self"], apply_norm(cfg, lp["ln1"], x),
                                   kv, cfg, index, positions, impl)
        hx = apply_norm(cfg, lp["ln_x"], h[:, None, :])[:, 0]
        h = h + _cross_attn_step(lp["cross"], hx, cache["cross"]["k"][layer],
                                 cache["cross"]["v"][layer], cfg, impl)
        x = h + mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"],
                                                h[:, None, :]), cfg)[:, 0]
    x = apply_norm(cfg, params["dec_norm"], x[:, None, :])[:, 0]
    w = params["embed"]["table"].T
    return (x @ w.to(x.dtype)).float(), cache
