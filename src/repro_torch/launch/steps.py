"""The secure-FL train step (replicated layout), prefill and serve step.

Counterpart of ``repro/launch/steps.py::make_train_step`` (:253) with
``fsdp=False``: every party holds the whole model, and per step

  this party's rows of the global batch -> fwd/bwd -> two-phase MPC
  gradient aggregation, leaf by leaf (``fl.spmd.secure_aggregate_tree``)
  -> AdamW -> identical parameters on every party.

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

Later slices: MPC-FSDP (``fsdp=True``, or ``fsdp=None`` resolving to it
for a model whose fp32 state does not fit 60 % of 16 GB), top-k
compression and the enc-dec family raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core.tree import flatten_with_path, tree_map, unflatten
from repro_torch.fl.spmd import (party_count, party_index,
                                 secure_aggregate_tree)
from repro_torch.kernels import dispatch
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import cache_batch_and_length
from repro_torch.optim import AdamWConfig, adamw_update

PROTOCOLS = ("two_phase", "p2p", "plain")
AGG_MODES = ("psum", "reduce_scatter")
FSDP_LATER = ("MPC-FSDP is not ported yet: it belongs to ROADMAP queue 1, "
              "item 5 of the PyTorch port (the replicated layout runs "
              "models whose fp32 parameters and Adam moments fit 60 % of "
              "16 GB, such as qwen1.5-0.5b)")
TOPK_LATER = ("compress_topk is not ported yet: it belongs to top-k "
              "compression (ROADMAP queue 1, item 6) of the PyTorch port")


#: device memory of the reference's chip, which its layout rule assumes
REFERENCE_HBM_BYTES = 16e9


def needs_fsdp(cfg: ArchConfig) -> bool:
    """The reference's layout rule (``launch/sharding.py:115``) at tensor
    parallelism 1: replicated fp32 params + Adam moments must fit 60 %
    of the reference chip's 16 GB."""
    return cfg.param_count() * (4 + 8) > 0.6 * REFERENCE_HBM_BYTES


def _psum_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    if n > 1:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x / n


class TrainStep:
    """``step(model, opt_state, step_idx, batch) -> (model, opt_state,
    loss)``.

    ``batch`` holds the global ``tokens``/``labels`` ``[B, S]`` (numpy
    or tensors); rank ``p`` of ``n`` trains on rows ``[p·B/n, (p+1)·B/n)``.
    The model's parameters and the moments are updated in place.
    ``loss`` is the mean over parties of each party's mean NLL.

    ``observe``: if set, ``observe(grads, aggregated)`` is called with
    the party's gradient tree (or pseudo-gradient) and its aggregate,
    before the optimizer — for checks of the aggregation.
    """

    def __init__(self, cfg: ArchConfig, *, protocol: str = "two_phase",
                 scheme: str = "additive", m: int = 3,
                 agg_mode: str = "psum", seed: int = 0,
                 fsdp: bool | None = None, opt: AdamWConfig | None = None,
                 attn_impl: str = "auto", local_steps: int = 1,
                 inner_lr: float = 0.02, compress_topk: float | None = None,
                 chunk_elems: int | None = None, group=None,
                 device="cuda"):
        self.api = get_api(cfg)
        if fsdp is None:
            fsdp = needs_fsdp(cfg)
        if fsdp:
            raise NotImplementedError(FSDP_LATER)
        if compress_topk:
            raise NotImplementedError(TOPK_LATER)
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
        self.opt = opt or AdamWConfig()
        self.attn_impl = attn_impl
        self.local_steps = local_steps
        self.inner_lr = inner_lr
        self.chunk_elems = chunk_elems
        self.group = group
        self.device = dispatch.resolve_device(device)
        self.observe = None

    @property
    def n_party(self) -> int:
        return party_count(self.group)

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
        leaves = [leaf for _, leaf in flatten_with_path(params)]
        loss = self.api.loss_fn(params, batch, self.cfg, impl=self.attn_impl)
        grads = torch.autograd.grad(loss, leaves)
        paths = [p for p, _ in flatten_with_path(params)]
        return loss.detach(), unflatten(paths, grads)

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

    def __call__(self, model, opt_state, step_idx: int, batch):
        local = self.local_batch(batch)
        params = model.params()
        with record_function("fwd_bwd"):
            if self.local_steps <= 1:
                loss, grads = self._grad(params, local)
            else:
                loss, grads = self._local_iterations(params, local)
        with record_function("secure_aggregate"):
            agg = self._aggregate(grads, step_idx)
        if self.observe is not None:
            self.observe(grads, agg)
        del grads
        loss = _psum_mean(loss, self.group, self.n_party)
        with record_function("adamw_update"):
            adamw_update(agg, opt_state, params, int(step_idx), self.opt)
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

def make_prefill(cfg: ArchConfig, attn_impl: str = "auto", device="cuda"):
    """``prefill(params, batch) -> logits [B, V]`` (float32, last
    position).  ``params``: the model's ``params()`` tree;
    ``batch["tokens"]`` ``[B, S]`` (numpy or a tensor) is moved to the
    step's device.  ``attn_impl="auto"`` runs the flash kernel (dense
    family), the selective-scan kernel (SSM family), or the RG-LRU scan
    and flash kernels (hybrid family) on the card; ``"dense"`` their
    plain paths."""
    api = get_api(cfg)
    device = dispatch.resolve_device(device)

    def prefill_fn(params, batch):
        tokens = torch.as_tensor(np.asarray(batch["tokens"])) \
            if not isinstance(batch["tokens"], torch.Tensor) \
            else batch["tokens"]
        with torch.no_grad():
            return api.prefill(params, {"tokens": tokens.to(device)}, cfg,
                               impl=attn_impl)

    return prefill_fn


class ServeStep:
    """``step(params, cache, dbatch) -> (token [B] int32, cache)``: one
    greedy decode step (``argmax`` of the logits, the first index on a
    tie, as ``jnp.argmax``).  ``params``: the model's ``params()`` tree;
    ``cache``: ``init_cache(params, cfg, batch, kv_len)`` of the model
    API (a KV cache, or SSM states), updated in place; ``dbatch``:
    ``tokens`` ``[B, 1]`` on the
    step's device, ``index`` a host int.

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
