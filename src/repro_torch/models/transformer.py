"""Decoder-only LM of the dense, MoE, SSM and hybrid families, as an
``nn.Module``.

Counterpart of ``repro/models/transformer.py`` for the dense family
(qwen1.5-0.5b, tinyllama-1.1b, llama3.2-1b; starcoder2-3b: layernorm, a
biased gelu MLP and a sliding window; qwen2-vl-2b: the embeddings
frontend, whose batches carry ``embeds`` ``[B, S, d]`` in place of
tokens), the MoE family
(qwen3-moe-235b-a22b, grok-1-314b: attention and a routed expert FFN
in every layer, ``models/moe.py``), the SSM family (falcon-mamba-7b,
``models/ssm.py``) and the hybrid family (recurrentgemma-9b: (rec, rec,
local-attn) triads and trailing rec layers, ``models/hybrid.py``): one
parameter schema and the training and serving entry points.

* ``init(cfg, seed, device)`` — a ``Transformer`` whose parameters are
  registered under the reference's tree keys, with the layers
  **stacked**: every leaf under ``layers`` has a leading ``L`` dim, as
  the reference's ``lax.scan`` stack has.  A hybrid's trailing layers
  sit unstacked in the **list** ``tail``, one block a layer, as the
  reference's (``['tail']/[0]/['rec']/['w_x']``).  So the gradient tree
  has the reference's 14 leaves for qwen1.5-0.5b (13 for
  falcon-mamba-7b, 72 for recurrentgemma-9b, 13 for a MoE config under
  ``layers/['b0_moe_attn']``), with the same key paths
  and element order, and the secure aggregation's per-leaf seeds
  (``fl.spmd.leaf_seed_tag``) and Philox streams are the reference's.
* ``loss_fn(params, batch, cfg, layer_transform=None)`` — next-token
  NLL over a nested dict of tensors (``model.params()``, or detached
  copies for local steps); ``layer_transform`` is the MPC-FSDP hook,
  applied to each layer group's parameters inside the layer's body
  (``launch/fsdp.py``).  A hybrid's tail layers are gathered with the
  top-level leaves instead (``top_gather``).
* ``from_reference`` / ``to_reference`` — the reference's parameter
  tree, as numpy arrays keyed by its leaf paths, into and out of the
  port's model.
* ``prefill(params, batch, cfg)`` — the last position's logits of a
  full forward (on the card: the flash kernel, the selective-scan
  kernel, or the RG-LRU scan kernel and the flash kernel with the
  local-attention window), as the reference's;
* ``init_cache`` / ``decode_step`` — the decode state in the reference's
  layout (a KV cache per attention layer, a ring buffer of
  ``min(kv_len, window)`` slots under a window; conv and SSM states per
  SSM layer; conv and RG-LRU states per rec layer; the tail's in the
  list ``cache["tail"]``) and one greedy-serving step against it.  The
  step updates the state in place (the reference returns a new one) and
  runs its attention through the decode kernel
  (``kernels/decode_attention``), where the reference computes it
  inline (ROADMAP queue 3, finding 4); the SSM and rec steps have no
  kernel, in either package.  A MoE layer's step routes the batch's
  ``B`` tokens under their own capacity, as the reference's: decode over
  a prompt equals prefill only where neither drops an assignment.

The loop over layers takes each stacked leaf apart once with ``unbind``,
so backward writes each leaf's gradient as one ``[L, ...]`` stack.
``cfg.remat`` wraps each layer in ``torch.utils.checkpoint`` while
autograd records: the backward recomputes the layer's forward with the
same operations, so no number changes.  The enc-dec family
(whisper-large-v3) is ``models/encdec.py``'s, built from this module's
attention block.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import flatten_with_path, path_str, unflatten
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention,
                                                  decode_attention_ref)
from . import hybrid, moe, ssm
from .attention import attention
from .common import ArchConfig, dtype_of, shard
from .layers import (apply_norm, apply_rope, chunked_softmax_xent, embed,
                     embedding_init, mlp_apply, mlp_init, norm_init)


def check_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for an enc-dec config, which
    ``models/encdec.py`` runs (``registry.get_api`` picks it)."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name} is an enc-dec config: "
                         "models/encdec.py runs it, not the decoder-only LM")


# ---------------------------------------------------------------------------
# Per-block init/apply
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ArchConfig, dtype, device=None):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = 1.0 / np.sqrt(d)
    so = 1.0 / np.sqrt(h * dh)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * scale

    p = {"wq": normal((d, h * dh), s), "wk": normal((d, hkv * dh), s),
         "wv": normal((d, hkv * dh), s), "wo": normal((h * dh, d), so)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    cd = x.dtype
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    q = shard(q, "batch", "heads", None, None)
    k = shard(k, "batch", "kv_heads", None, None)
    v = shard(v, "batch", "kv_heads", None, None)
    if cfg.rope in ("rope", "mrope"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ArchConfig, positions, impl: str = "auto",
               causal: bool = True):
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attention(q, k, v, cfg, causal=causal, impl=impl)
    o = shard(o, "batch", "heads", None, None)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return o @ p["wo"].to(x.dtype)


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "moe_attn", "ssm", "rec"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet ('attn', 'moe_attn', "
            "'ssm' and 'rec' only)")


def block_init(gen, cfg: ArchConfig, dtype, kind: str, device=None):
    _check_kind(kind)
    if kind == "ssm":
        return {"ln": norm_init(cfg, dtype, device),
                "ssm": ssm.ssm_block_init(gen, cfg, dtype, device)}
    if kind == "rec":
        return {"ln": norm_init(cfg, dtype, device),
                "rec": hybrid.rec_block_init(gen, cfg, dtype, device),
                "ln2": norm_init(cfg, dtype, device),
                "mlp": mlp_init(gen, cfg, dtype, device)}
    p = {"ln1": norm_init(cfg, dtype, device),
         "attn": attn_init(gen, cfg, dtype, device),
         "ln2": norm_init(cfg, dtype, device)}
    if kind == "moe_attn":
        p["moe"] = moe.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, dtype, device)
    return p


def block_apply(p, x, cfg: ArchConfig, positions, kind: str,
                impl: str = "auto"):
    _check_kind(kind)
    if kind == "ssm":
        return x + ssm.ssm_block_apply(p["ssm"], apply_norm(cfg, p["ln"], x),
                                       cfg, impl=impl)
    if kind == "rec":
        h = x + hybrid.rec_block_apply(p["rec"], apply_norm(cfg, p["ln"], x),
                                       cfg, impl=impl)
        return h + mlp_apply(p["mlp"], apply_norm(cfg, p["ln2"], h), cfg)
    h = x + attn_apply(p["attn"], apply_norm(cfg, p["ln1"], x), cfg,
                       positions, impl=impl)
    inner = apply_norm(cfg, p["ln2"], h)
    if kind == "moe_attn":
        return h + moe.moe_apply(p["moe"], inner, cfg)
    return h + mlp_apply(p["mlp"], inner, cfg)


# ---------------------------------------------------------------------------
# Layer-stack plan (which kinds, how stacked)
# ---------------------------------------------------------------------------

def stack_plan(cfg: ArchConfig) -> tuple[tuple[str, ...], int,
                                         tuple[str, ...]]:
    """Returns (group_kinds, n_groups, tail_kinds), as the reference: one
    ``ssm``, ``moe_attn`` (a MoE config) or ``attn`` block per layer, or
    the hybrid's groups of its block pattern (``rec, rec, attn``) and its
    ``rec`` tail."""
    if cfg.family == "ssm":
        return ("ssm",), cfg.n_layers, ()
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern or ("rec", "rec", "attn")
        n_groups = (cfg.n_layers - cfg.n_tail_layers) // len(pattern)
        return tuple(pattern), n_groups, ("rec",) * cfg.n_tail_layers
    return ("moe_attn" if cfg.n_experts else "attn",), cfg.n_layers, ()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _register(module: nn.Module, tree) -> None:
    """Registers a tree of dicts and lists (a list item under its index,
    as a name: ``tail.0.rec.w_x``)."""
    items = (enumerate(tree) if isinstance(tree, list)
             else ((key, tree[key]) for key in sorted(tree)))
    for key, value in items:
        if isinstance(value, (dict, list)):
            child = nn.Module()
            _register(child, value)
            module.add_module(str(key), child)
        else:
            module.register_parameter(str(key), nn.Parameter(value))


class ParamTree(nn.Module):
    """A model whose parameters sit under the reference's tree keys."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, tree)

    def params(self) -> dict:
        """The parameters as the reference's nested tree (a list keyed by
        int)."""
        names = [tuple(int(k) if k.isdigit() else k
                       for k in name.split("."))
                 for name, _ in self.named_parameters()]
        return unflatten(names, [p for _, p in self.named_parameters()])


class Transformer(ParamTree):
    """An LM whose parameters sit under the reference's tree keys
    (``embed.table``, ``layers.b0_attn.attn.wq`` [L, d, h·dh],
    ``tail.0.rec.w_x``, ...)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        check_family(cfg)
        super().__init__(cfg, tree)


def _model_device(device) -> torch.device:
    """The card unless ``device="cpu"``; ``"meta"`` builds shapes only."""
    device = torch.device(device)
    return device if device.type == "meta" else dispatch.resolve_device(
        device)


def generator(device: torch.device, seed: int):
    """The draws of ``init`` on ``device`` (none on the meta device, which
    holds shapes only)."""
    return (None if device.type == "meta"
            else torch.Generator(device=device).manual_seed(int(seed)))


def stacked_layers(n: int, draw_layer, device: torch.device) -> dict:
    """``n`` layers of ``draw_layer()`` (a tree), each leaf stacked on a
    leading ``L`` dim.  Each stacked leaf is allocated once and filled
    layer by layer, in the order the layers are drawn: the layers never
    exist twice."""
    paths, stacked = None, None
    for layer in range(n):
        tree = flatten_with_path(draw_layer())
        if stacked is None:
            paths = [p for p, _ in tree]
            stacked = [torch.empty((n,) + tuple(leaf.shape),
                                   dtype=leaf.dtype, device=device)
                       for _, leaf in tree]
        if device.type != "meta":
            for dst, (_, leaf) in zip(stacked, tree):
                dst[layer].copy_(leaf)
        del tree
    return unflatten(paths, stacked)


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> Transformer:
    """A ``Transformer`` with weights drawn from ``seed`` on ``device``,
    with the reference's scales (embedding 0.02, projections
    ``1/sqrt(fan_in)``, norm scales 1, biases 0; the SSM block's as the
    reference's ``ssm_block_init``), the layers stacked
    (``stacked_layers``)."""
    check_family(cfg)
    device = _model_device(device)
    dtype = dtype_of(cfg, "param_dtype")
    group_kinds, n_groups, tail_kinds = stack_plan(cfg)
    gen = generator(device, seed)
    layers = stacked_layers(
        n_groups, lambda: {f"b{i}_{kind}": block_init(gen, cfg, dtype, kind,
                                                      device)
                           for i, kind in enumerate(group_kinds)}, device)
    tree: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "layers": layers,
        "final_norm": norm_init(cfg, dtype, device),
    }
    if tail_kinds:
        tree["tail"] = [block_init(gen, cfg, dtype, kind, device)
                        for kind in tail_kinds]
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": torch.randn(
            (cfg.d_model, cfg.vocab), generator=gen, dtype=dtype,
            device=device) * (1.0 / np.sqrt(cfg.d_model))}
    return Transformer(cfg, tree)


def from_reference(cfg: ArchConfig, arrays: dict[str, np.ndarray],
                   device="cuda") -> Transformer:
    """The port's model holding the reference's weights.

    ``arrays`` maps each leaf path as the reference prints it
    (``"['layers']/['b0_attn']/['attn']/['wq']"``) to its numpy array.
    """
    return load_tree(Transformer, cfg, arrays, _schema_paths(cfg), device)


def load_tree(cls, cfg: ArchConfig, arrays: dict[str, np.ndarray],
              schema_paths, device) -> ParamTree:
    """``cls(cfg, tree)`` of ``arrays`` keyed by reference path, which must
    be the paths of ``schema_paths``."""
    want = {path_str(p): p for p in schema_paths}
    if set(arrays) != set(want):
        raise ValueError(
            f"leaf paths differ from the {cfg.name} schema: missing "
            f"{sorted(set(want) - set(arrays))}, unexpected "
            f"{sorted(set(arrays) - set(want))}")
    device = _model_device(device)
    paths = [want[k] for k in sorted(want)]
    leaves = [torch.as_tensor(np.asarray(arrays[path_str(p)]),
                              device=device).clone() for p in paths]
    return cls(cfg, unflatten(paths, leaves))


def to_reference(model: ParamTree) -> dict[str, np.ndarray]:
    """The model's parameters as numpy arrays keyed by reference path."""
    return {path_str(p): leaf.detach().cpu().numpy()
            for p, leaf in flatten_with_path(model.params())}


def _schema_paths(cfg: ArchConfig):
    """Leaf paths of the model ``init(cfg)`` builds (on the meta
    device: no memory, no weights)."""
    model = init(cfg, device="meta")
    return [p for p, _ in flatten_with_path(model.params())]


# ---------------------------------------------------------------------------
# Forward (full sequence) + loss
# ---------------------------------------------------------------------------

def _run_stack(params, x, cfg: ArchConfig, positions, impl: str,
               layer_transform=None):
    """``layer_transform(group_params, group_index) -> group_params`` lets
    the trainer interpose per-layer parameter movement (the MPC-FSDP
    all-gather whose backward is a secure reduce-scatter).  It runs
    inside the layer's body, so under ``remat`` backward recomputes it
    with the layer, as under the reference's ``jax.checkpoint``."""
    group_kinds, n_groups, tail_kinds = stack_plan(cfg)
    flat = flatten_with_path(params["layers"])
    paths = [p for p, _ in flat]
    per_layer = list(zip(*(leaf.unbind(0) for _, leaf in flat)))
    if len(per_layer) != n_groups:
        raise ValueError(f"{len(per_layer)} stacked layers, expected "
                         f"{n_groups}")

    def group_body(xc, gidx, *layer_leaves):
        gp = unflatten(paths, layer_leaves)
        if layer_transform is not None:
            gp = layer_transform(gp, gidx)
        for i, kind in enumerate(group_kinds):
            xc = block_apply(gp[f"b{i}_{kind}"], xc, cfg, positions, kind,
                             impl=impl)
        return xc

    for gidx, layer_leaves in enumerate(per_layer):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(group_body, x, gidx, *layer_leaves,
                           use_reentrant=False)
        else:
            x = group_body(x, gidx, *layer_leaves)
    for tp, kind in zip(params.get("tail", []), tail_kinds):
        x = block_apply(tp, x, cfg, positions, kind, impl=impl)
    return apply_norm(cfg, params["final_norm"], x)


def forward_hidden(params, batch, cfg: ArchConfig, impl: str = "auto",
                   layer_transform=None):
    check_family(cfg)
    cd = dtype_of(cfg, "compute_dtype")
    if cfg.frontend == "embeddings":
        x = batch["embeds"].to(cd)
    else:
        x = embed(params["embed"], batch["tokens"], cd)
    b, s, _ = x.shape
    x = shard(x, "batch", "seq", "embed")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    return _run_stack(params, x, cfg, positions, impl,
                      layer_transform=layer_transform)


def lm_head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def loss_fn(params, batch, cfg: ArchConfig, impl: str = "auto",
            layer_transform=None):
    """Mean next-token NLL.  batch: tokens ``[B,S]`` (or embeds
    ``[B,S,d]``), labels ``[B,S]``."""
    h = forward_hidden(params, batch, cfg, impl=impl,
                       layer_transform=layer_transform)
    w = lm_head_weight(params, cfg)
    return chunked_softmax_xent(h, w, batch["labels"],
                                label_mask=batch.get("label_mask"))


def prefill(params, batch, cfg: ArchConfig, impl: str = "auto"):
    """Last-position logits ``[B, V]`` (float32) of a full forward over
    ``batch["tokens"]`` ``[B, S]`` (the embeddings frontend:
    ``batch["embeds"]`` ``[B, S, d]``).  As the reference's, it builds no
    cache: serving fills the cache by decode steps."""
    h = forward_hidden(params, batch, cfg, impl=impl)
    w = lm_head_weight(params, cfg)
    last = h[:, -1, :]
    return (last @ w.to(last.dtype)).float()


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

#: the reference keeps its cache in bfloat16 whatever the compute dtype
#: (``repro/models/transformer.py:269``)
CACHE_DTYPE = torch.bfloat16


def init_cache(cfg: ArchConfig, batch: int, kv_len: int,
               dtype=CACHE_DTYPE, device="cuda"):
    """Zeroed decode state: ``{"groups": {"b0_attn": {"k", "v"}}}``, each
    ``[L, B, Hkv, S_buf, Dh]`` of ``dtype``, on ``device`` (the card
    unless ``device="cpu"``), where ``S_buf`` is ``kv_len``, or
    ``min(kv_len, cfg.window)`` under a sliding window (a ring buffer).
    An SSM layer group holds ``{"conv": [L, B, k-1, di], "ssm": [L, B,
    di, st]}`` instead, and a rec layer group ``{"conv": [L, B, 3, W],
    "h": [L, B, W]}``, all float32 whatever ``dtype`` (as the
    reference's), whose size does not grow with ``kv_len``.  A hybrid's
    tail layers hold theirs in the list ``cache["tail"]``, each with a
    leading dim of 1, as the reference's."""
    check_family(cfg)
    device = dispatch.resolve_device(device)
    group_kinds, n_groups, tail_kinds = stack_plan(cfg)

    def one(kind, n):
        if kind in ("ssm", "rec"):
            state = (ssm.ssm_init_state if kind == "ssm"
                     else hybrid.rec_init_state)(cfg, batch, device="meta")
            return {name: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                                      device=device)
                    for name, t in state.items()}
        s_buf = min(kv_len, cfg.window) if cfg.window else kv_len
        shape = (n, batch, cfg.n_kv_heads, s_buf, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"groups": {f"b{i}_{kind}": one(kind, n_groups)
                        for i, kind in enumerate(group_kinds)}}
    if tail_kinds:
        cache["tail"] = [one(kind, 1) for kind in tail_kinds]
    return cache


def cache_batch_and_length(cache) -> tuple[int, int | None]:
    """The batch of a cache from ``init_cache``, and the length of its KV
    buffers (``None`` for a model without attention, whose state does
    not grow: SSM).  An enc-dec cache (``models/encdec.py``) holds its
    self-attention ``k``, ``v`` ``[L, B, H, S, Dh]`` at the top level."""
    if "groups" not in cache:
        return cache["k"].shape[1], cache["k"].shape[3]
    groups = list(cache["groups"].values()) + list(cache.get("tail", []))
    batch = next(iter(groups[0].values())).shape[1]
    kv = next((g["k"] for g in groups if "k" in g), None)
    return batch, None if kv is None else kv.shape[3]


def _decode_attn_block(p, x, cache_kv, cfg: ArchConfig, index: int,
                       positions, impl: str):
    """One-token attention against the KV cache, whose slot
    ``index % S_buf`` takes this token's key and value in place.

    x: ``[B, d]``; cache_kv: {k, v: ``[B, Hkv, S_buf, Dh]``}; positions:
    ``[B, 1]`` (all ``index``).  Slots ``0..index`` hold positions
    ``0..index`` (once ``index`` passes ``S_buf`` the ring holds the last
    ``S_buf``, every slot valid, as in the reference): the decode kernel
    reads ``kv_len = min(index + 1, S_buf)`` of them.
    """
    b = x.shape[0]
    cd = x.dtype
    q, k_new, v_new = _project_qkv(p, x[:, None, :], cfg, positions)
    s_buf = cache_kv["k"].shape[2]
    slot = index % s_buf
    # rounded to the cache's dtype before attention, as the reference's
    cache_kv["k"][:, :, slot] = k_new[:, :, 0]
    cache_kv["v"][:, :, slot] = v_new[:, :, 0]
    kv_len = min(index + 1, s_buf)
    if impl == "dense":
        acc, m, l = decode_attention_ref(q[:, :, 0], cache_kv["k"],
                                         cache_kv["v"], kv_len=kv_len)
        o = combine_partials(acc[None], m[None], l[None]).to(cd)
    else:
        o = decode_attention(q[:, :, 0], cache_kv["k"], cache_kv["v"],
                             kv_len=kv_len)
    o = o.reshape(b, cfg.n_heads * cfg.d_head)
    return o @ p["wo"].to(cd)


def _decode_block(p, x, cache_kv, cfg: ArchConfig, index: int, positions,
                  kind: str, impl: str):
    _check_kind(kind)
    if kind == "ssm":
        y, _ = ssm.ssm_block_step(p["ssm"], apply_norm(cfg, p["ln"], x),
                                  cache_kv, cfg)
        return x + y
    if kind == "rec":
        y, _ = hybrid.rec_block_step(p["rec"], apply_norm(cfg, p["ln"], x),
                                     cache_kv, cfg)
        h = x + y
        inner = apply_norm(cfg, p["ln2"], h[:, None, :])
        return h + mlp_apply(p["mlp"], inner, cfg)[:, 0]
    h = x + _decode_attn_block(p["attn"], apply_norm(cfg, p["ln1"], x),
                               cache_kv, cfg, index, positions, impl)
    inner = apply_norm(cfg, p["ln2"], h[:, None, :])
    if kind == "moe_attn":
        return h + moe.moe_apply(p["moe"], inner, cfg)[:, 0]
    return h + mlp_apply(p["mlp"], inner, cfg)[:, 0]


def decode_step(params, cache, batch, cfg: ArchConfig, impl: str = "auto"):
    """One decode step.  batch: ``tokens`` ``[B, 1]`` (the embeddings
    frontend: ``embeds`` ``[B, 1, d]``), ``index`` (a host int: the
    current absolute position).

    Returns (logits ``[B, V]`` float32, the cache, updated in place).
    ``impl``: ``"auto"`` runs the decode-attention wrapper (the CUDA
    kernel on the card, its plain version on the CPU); ``"dense"`` its
    plain version on any device.  An SSM or rec layer's step is plain
    PyTorch whatever ``impl`` (the reference has no kernel for it).
    """
    check_family(cfg)
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown decode impl {impl!r}: auto or dense")
    cd = dtype_of(cfg, "compute_dtype")
    index = int(batch["index"])
    if cfg.frontend == "embeddings":
        x = batch["embeds"][:, 0, :].to(cd)
    else:
        x = embed(params["embed"], batch["tokens"][:, 0], cd)
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int64,
                           device=x.device)
    group_kinds, n_groups, tail_kinds = stack_plan(cfg)
    flat = flatten_with_path(params["layers"])
    paths = [p for p, _ in flat]
    per_layer = list(zip(*(leaf.unbind(0) for _, leaf in flat)))
    if len(per_layer) != n_groups:
        raise ValueError(f"{len(per_layer)} stacked layers, expected "
                         f"{n_groups}")
    for layer, layer_leaves in enumerate(per_layer):
        gp = unflatten(paths, layer_leaves)
        for i, kind in enumerate(group_kinds):
            name = f"b{i}_{kind}"
            kv = {key: buf[layer]
                  for key, buf in cache["groups"][name].items()}
            x = _decode_block(gp[name], x, kv, cfg, index, positions, kind,
                              impl)
    for tp, tc, kind in zip(params.get("tail", []), cache.get("tail", []),
                            tail_kinds):
        state = {key: buf[0] for key, buf in tc.items()}
        x = _decode_block(tp, x, state, cfg, index, positions, kind, impl)
    x = apply_norm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    w = lm_head_weight(params, cfg)
    return (x @ w.to(x.dtype)).float(), cache
