"""The secure-FL train step (replicated and MPC-FSDP layouts), prefill
and serve step.

Counterpart of ``repro/launch/steps.py::make_train_step`` (:253).  Per
step and party:

  this party's rows of the global batch -> fwd/bwd -> two-phase MPC
  gradient aggregation -> AdamW -> identical parameters on every party.

Two parameter layouts, as the reference's:

* **replicated** (the paper's FL): every party holds the whole model;
  the gradients are securely averaged leaf by leaf
  (``fl.spmd.secure_aggregate_tree``);
* **MPC-FSDP** (``fsdp=True``; ``fsdp=None`` picks it where the fp32
  parameters and Adam moments pass 60 % of the reference chip's 16 GB,
  ``launch.sharding.needs_fsdp``): each party holds its shards of the
  parameters and moments; each layer is gathered on entry and the
  gather's backward is a secure reduce-scatter of shares
  (``launch/fsdp.py``).  The leaves the layout keeps whole (norm scales,
  biases) are averaged after backward as in the replicated layout, and
  the clip's global norm is the whole gradient's: the reference leaves
  both per party (ROADMAP queue 3, finding 9); in a world of one the
  two agree.

``compress_topk`` sparsifies each party's gradient (or pseudo-gradient)
leaf by leaf before the aggregation, keeping the unsent mass in
``opt_state["ef"]``: this party's ``[1, *leaf]`` row of the reference's
``[n_party, *leaf]`` residuals (``init_error_feedback``, ``ef_row``,
``join_ef_rows``).

Each party is one rank of the process group (``launch.mesh``); the
reference's ``shard_map`` over the party axes becomes each rank taking
its own rows of the global batch.  ``record_function`` ranges name the
step's parts for a profiler: ``fwd_bwd``, ``secure_aggregate`` and
``adamw_update``.

``make_prefill`` and ``make_serve_step`` are the counterparts of the
reference's (:432-470) without ``jit`` or a mesh: plain callables on one
device, run without autograd.  ``attn_impl`` reaches every block: the
attention rule and the scan rules of the SSM and rec blocks
(``models/ssm.py``, ``models/hybrid.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core.compression import (CompressionConfig,
                                          compress_topk_batch)
from repro_torch.core.tree import flatten_with_path, tree_map, unflatten
from repro_torch.fl.spmd import (party_count, party_index,
                                 secure_aggregate_tree)
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import cache_batch_and_length
from repro_torch.optim import AdamWConfig, adamw_update
from .fsdp import gather_tree, make_fsdp_transforms, party_dims, shard_tree
from .sharding import needs_fsdp

PROTOCOLS = ("two_phase", "p2p", "plain")

TRAIN_LATER = (
    "training {name} is not ported yet: the training of the enc-dec "
    "family, the embeddings frontend and the layernorm / gelu / "
    "sliding-window dense block (whisper-large-v3, qwen2-vl-2b, "
    "starcoder2-3b), which serve, belongs to ROADMAP queue 1, item 15 of "
    "the PyTorch port")


def check_trainable(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for the architectures that serve but
    do not train yet: enc-dec, the embeddings frontend, and a dense or
    MoE block with layernorm, an ungated gelu MLP or a window."""
    block = (cfg.family in ("ssm", "hybrid")
             or (cfg.norm, cfg.act, cfg.window) == ("rmsnorm", "silu", 0))
    if cfg.enc_dec or cfg.frontend == "embeddings" or not block:
        raise NotImplementedError(TRAIN_LATER.format(name=cfg.name))
AGG_MODES = ("psum", "reduce_scatter")


def _psum_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    if n > 1:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x / n


# ---------------------------------------------------------------------------
# top-k gradient compression (per-party error feedback in the opt state)
# ---------------------------------------------------------------------------

def init_error_feedback(params, n_party: int = 1):
    """Zero residuals: ``n_party`` float32 rows per leaf (the reference's
    ``[n_party, *leaf]``).  A rank of the port keeps its own row:
    ``n_party=1``, or ``ef_row`` of the reference's."""
    return tree_map(lambda p: torch.zeros((n_party,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def ef_row(ef, pid: int):
    """Party ``pid``'s ``[1, *leaf]`` rows of ``[n_party, *leaf]``
    residuals."""
    return tree_map(lambda e: e[pid:pid + 1].clone(), ef)


def join_ef_rows(rows: list):
    """The ``[n_party, *leaf]`` residuals of the parties' rows, in party
    order."""
    return tree_map(lambda *es: torch.cat(es), rows[0], *rows[1:])


def _compress_tree_topk(grads, ef, ratio: float):
    """Leaf-wise top-k + error feedback of a party's gradient tree; ``ef``
    leaves are the party's ``[1, *leaf]`` rows.  Returns the densified
    tree (what the secure aggregation shares) and the new residuals."""
    ccfg = CompressionConfig(enabled=True, top_k_ratio=ratio,
                             error_feedback=True)
    e_by_path = dict(flatten_with_path(ef))
    dense, new_ef = [], []
    paths = []
    for path, g in flatten_with_path(grads):
        e = e_by_path[path]
        d, ne = compress_topk_batch(g.reshape(1, -1), ccfg, e.reshape(1, -1))
        paths.append(path)
        dense.append(d.reshape(g.shape).to(g.dtype))
        new_ef.append(ne.reshape(e.shape))
    return unflatten(paths, dense), unflatten(paths, new_ef)


# ---------------------------------------------------------------------------
# train_step factory
# ---------------------------------------------------------------------------

class TrainStep:
    """``step(model, opt_state, step_idx, batch) -> (model, opt_state,
    loss)``.

    ``batch`` holds the global ``tokens``/``labels`` ``[B, S]`` (numpy
    or tensors); rank ``p`` of ``n`` trains on rows ``[p·B/n, (p+1)·B/n)``.
    The model's parameters and the moments are updated in place.
    ``loss`` is the mean over parties of each party's mean NLL.  Under
    MPC-FSDP the model holds this party's shards (``shard_model``) and
    the moments are the shards'.

    whisper-large-v3, qwen2-vl-2b and starcoder2-3b serve but do not
    train yet (``check_trainable``: ROADMAP queue 1, item 15).

    ``observe``: if set, ``observe(grads, aggregated)`` is called with
    the party's gradient tree (or pseudo-gradient; densified under
    top-k; under MPC-FSDP the split leaves' are already aggregated) and
    its aggregate, before the optimizer — for checks of the aggregation.
    """

    def __init__(self, cfg: ArchConfig, *, protocol: str = "two_phase",
                 scheme: str = "additive", m: int = 3,
                 agg_mode: str = "psum", seed: int = 0,
                 fsdp: bool | None = None, opt: AdamWConfig | None = None,
                 attn_impl: str = "auto", local_steps: int = 1,
                 inner_lr: float = 0.02, compress_topk: float | None = None,
                 chunk_elems: int | None = None, gather_dtype=None,
                 group=None, device="cuda"):
        if fsdp is None:
            fsdp = needs_fsdp(cfg)
        if fsdp and cfg.enc_dec:
            raise NotImplementedError("MPC-FSDP not wired for enc-dec archs")
        check_trainable(cfg)
        if fsdp and local_steps > 1:
            raise NotImplementedError("local_steps requires replicated "
                                      "params")
        if fsdp and compress_topk:
            raise NotImplementedError(
                "compress_topk requires replicated params (FSDP aggregates "
                "inside backward, before compression could apply)")
        if compress_topk is not None and not 0.0 <= compress_topk <= 1.0:
            raise ValueError(
                f"compress_topk={compress_topk} must be in [0, 1]")
        self.api = get_api(cfg)
        if protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r}; expected one "
                             f"of {PROTOCOLS}")
        if agg_mode not in AGG_MODES:
            raise ValueError(f"unknown agg_mode {agg_mode!r}; expected one "
                             f"of {AGG_MODES}")
        self.cfg = cfg
        self.protocol = protocol
        self.scheme = scheme
        self.m = m
        self.agg_mode = agg_mode
        self.seed = seed
        self.fsdp = fsdp
        self.opt = opt or AdamWConfig()
        self.attn_impl = attn_impl
        self.local_steps = local_steps
        self.inner_lr = inner_lr
        self.compress_topk = compress_topk or None
        self.chunk_elems = chunk_elems
        self.gather_dtype = gather_dtype
        self.group = group
        self.device = dispatch.resolve_device(device)
        self.observe = None
        self._dims: dict | None = None

    @property
    def n_party(self) -> int:
        return party_count(self.group)

    # -- MPC-FSDP layout ----------------------------------------------------

    @property
    def dims(self) -> dict:
        """``{leaf path: dim split among the parties, or None}``."""
        if self._dims is None:
            shapes = {p: tuple(leaf.shape) for p, leaf in flatten_with_path(
                transformer.init(self.cfg, device="meta").params())}
            self._dims = party_dims(shapes, self.n_party)
        return self._dims

    def shard_model(self, model):
        """The model holding this party's shards of ``model``'s leaves
        (the whole leaves where the layout keeps them whole)."""
        with torch.no_grad():
            tree = shard_tree(model.params(), self.dims, self.group)
        return transformer.Transformer(self.cfg, tree)

    def full_params(self, tree):
        """The whole leaves of a tree of this layout's shards (parameters
        or moments), gathered from every party; the tree itself in the
        replicated layout."""
        if not self.fsdp:
            return tree
        with torch.no_grad():
            return gather_tree(tree, self.dims, self.group)

    def local_batch(self, batch) -> dict:
        """This party's rows of the global batch, on the step's device."""
        n, pid = self.n_party, party_index(self.group)
        out = {}
        for k in ("tokens", "labels", "label_mask"):
            if k not in batch:
                continue
            a = batch[k]
            b = a.shape[0]
            if b % n:
                raise ValueError(f"global batch {b} does not split among "
                                 f"{n} parties")
            rows = a[pid * (b // n):(pid + 1) * (b // n)]
            t = torch.as_tensor(np.asarray(rows) if not isinstance(
                rows, torch.Tensor) else rows)
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _grad(self, params, batch):
        flat = flatten_with_path(params)
        if self.fsdp:
            layer_transform, top_gather = make_fsdp_transforms(
                self.dims, m=self.m, seed=self.seed,
                gather_dtype=self.gather_dtype, group=self.group)
            loss = self.api.loss_fn(top_gather(params), batch, self.cfg,
                                    impl=self.attn_impl,
                                    layer_transform=layer_transform)
        else:
            loss = self.api.loss_fn(params, batch, self.cfg,
                                    impl=self.attn_impl)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
        return loss.detach(), unflatten([p for p, _ in flat], grads)

    def _aggregate(self, tree, step_idx: int):
        n = self.n_party
        if self.protocol == "plain":
            return tree_map(lambda g: _psum_mean(g.float(), self.group, n),
                            tree)
        mode = "p2p" if self.protocol == "p2p" else self.agg_mode
        return secure_aggregate_tree(
            tree, scheme=self.scheme, m=self.m, group=self.group,
            seed=self.seed, round_index=int(step_idx), mode=mode,
            chunk_elems=self.chunk_elems)

    def _aggregate_fsdp(self, grads, step_idx: int):
        """The split leaves' gradients are aggregated already (in
        backward); the whole leaves' are aggregated here, as in the
        replicated layout.  Returns the aggregate and the whole
        gradient's global norm."""
        flat = flatten_with_path(grads)
        whole = [(p, g) for p, g in flat if self.dims[p] is None]
        agg = dict(flatten_with_path(self._aggregate(
            unflatten([p for p, _ in whole], [g for _, g in whole]),
            step_idx))) if whole else {}
        out = [agg.get(p, g) for p, g in flat]
        # the clip's norm over the whole gradient: a split leaf's squares
        # summed over the parties (its shards), in the leaves' order
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in out])
        split = torch.tensor([self.dims[p] is not None for p, _ in flat],
                             device=sq.device)
        if self.n_party > 1:
            parts = torch.where(split, sq, torch.zeros_like(sq))
            dist.all_reduce(parts, group=self.group)
            sq = torch.where(split, parts, sq)
        return unflatten([p for p, _ in flat], out), torch.sqrt(torch.sum(sq))

    def __call__(self, model, opt_state, step_idx: int, batch):
        local = self.local_batch(batch)
        params = model.params()
        ef = opt_state.get("ef") if self.compress_topk else None
        moments = {k: v for k, v in opt_state.items() if k != "ef"}
        with record_function("fwd_bwd"):
            if self.local_steps <= 1:
                loss, grads = self._grad(params, local)
            else:
                loss, grads = self._local_iterations(params, local)
            if self.compress_topk:
                grads, ef = _compress_tree_topk(grads, ef,
                                                self.compress_topk)
        norm = None
        with record_function("secure_aggregate"):
            if self.fsdp:
                agg, norm = self._aggregate_fsdp(grads, step_idx)
            else:
                agg = self._aggregate(grads, step_idx)
        if self.observe is not None:
            self.observe(grads, agg)
        del grads
        loss = _psum_mean(loss, self.group, self.n_party)
        with record_function("adamw_update"):
            adamw_update(agg, moments, params, int(step_idx), self.opt,
                         norm=norm)
        if ef is not None:
            opt_state["ef"] = ef
        return model, opt_state, loss

    def _local_iterations(self, params, local):
        """The paper's t local iterations per aggregation (Alg. 3 line
        5): t SGD steps of ``inner_lr`` on micro-batches of this party's
        rows, then the pseudo-gradient ``(params - local)/inner_lr``."""
        t = self.local_steps
        b = local["tokens"].shape[0]
        if b % t:
            raise ValueError(f"{b} rows per party do not split into "
                             f"{t} local steps")
        p_loc = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                         params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(t):
            mb = {k: v.reshape((t, b // t) + tuple(v.shape[1:]))[i]
                  for k, v in local.items()}
            loss, g = self._grad(p_loc, mb)
            with torch.no_grad():
                p_loc = tree_map(
                    lambda a, gg: (a.float() - self.inner_lr * gg.float())
                    .to(a.dtype).requires_grad_(True), p_loc, g)
            loss_sum = loss_sum + loss
        lr = torch.full((), self.inner_lr, dtype=torch.float32,
                        device=self.device)
        with torch.no_grad():
            pseudo = tree_map(lambda a, b_: (a.float() - b_.float()) / lr,
                              params, p_loc)
        return loss_sum / t, pseudo


def make_train_step(cfg: ArchConfig, **kw) -> TrainStep:
    """The train step of ``cfg`` (keywords as ``TrainStep``)."""
    return TrainStep(cfg, **kw)


# ---------------------------------------------------------------------------
# prefill / serve_step factories
# ---------------------------------------------------------------------------

#: the batch entries prefill moves to its device: token ids, the
#: embeddings frontend's ``embeds`` ``[B, S, d]``, the enc-dec family's
#: post-conv ``frames`` ``[B, enc_seq, d]``
PREFILL_INPUTS = ("tokens", "embeds", "frames")


def make_prefill(cfg: ArchConfig, attn_impl: str = "auto", device="cuda"):
    """``prefill(params, batch) -> logits [B, V]`` (float32, last
    position).  ``params``: the model's ``params()`` tree; the batch's
    ``tokens`` ``[B, S]``, ``embeds`` and ``frames`` (numpy or tensors;
    those the model reads) are moved to the step's device.
    ``attn_impl="auto"`` runs the flash kernel (dense, MoE and enc-dec
    families), the selective-scan kernel (SSM family), or the RG-LRU
    scan and flash kernels (hybrid family) on the card; ``"dense"``
    their plain paths."""
    api = get_api(cfg)
    device = dispatch.resolve_device(device)

    def prefill_fn(params, batch):
        moved = {key: torch.as_tensor(np.asarray(batch[key]))
                 .to(device) if not isinstance(batch[key], torch.Tensor)
                 else batch[key].to(device)
                 for key in PREFILL_INPUTS if key in batch}
        with torch.no_grad():
            return api.prefill(params, moved, cfg, impl=attn_impl)

    return prefill_fn


class ServeStep:
    """``step(params, cache, dbatch) -> (token [B] int32, cache)``: one
    greedy decode step (``argmax`` of the logits, the first index on a
    tie, as ``jnp.argmax``).  ``params``: the model's ``params()`` tree;
    ``cache``: ``init_cache(params, cfg, batch, kv_len)`` of the model
    API (a KV cache, or SSM states; an enc-dec model's also holds the
    encoder's cross K/V), updated in place; ``dbatch``: ``tokens``
    ``[B, 1]`` (the embeddings frontend: ``embeds`` ``[B, 1, d]``) on the
    step's device, ``index`` a host int, handed to the model's
    ``decode_step`` as they are.

    ``observe``: if set, ``observe(dbatch, logits)`` is called with each
    step's float32 logits before the argmax — for checks of the step.
    """

    def __init__(self, cfg: ArchConfig, kv_len: int, batch: int, *,
                 device="cuda"):
        self.api = get_api(cfg)
        self.cfg = cfg
        self.kv_len = kv_len
        self.batch = batch
        self.device = dispatch.resolve_device(device)
        self.observe = None

    @property
    def cache_length(self) -> int:
        """The KV buffers' length: ``kv_len``, or ``min(kv_len, window)``
        under a sliding window (the ring buffer of ``init_cache``)."""
        window = self.cfg.window
        return min(self.kv_len, window) if window else self.kv_len

    def __call__(self, params, cache, dbatch):
        batch, length = cache_batch_and_length(cache)
        if batch != self.batch or length not in (None, self.cache_length):
            raise ValueError(f"cache of batch {batch} × length {length}; "
                             f"the step serves {self.batch} × "
                             f"{self.cache_length}")
        with torch.no_grad():
            logits, cache = self.api.decode_step(params, cache, dbatch,
                                                 self.cfg)
            if self.observe is not None:
                self.observe(dbatch, logits)
            token = logits.argmax(dim=-1).to(torch.int32)
        return token, cache


def make_serve_step(cfg: ArchConfig, kv_len: int, batch: int, **kw):
    """The greedy serve step of ``cfg`` (keywords as ``ServeStep``)."""
    return ServeStep(cfg, kv_len, batch, **kw)
