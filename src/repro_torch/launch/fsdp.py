"""MPC-FSDP: parameters split among the parties, gathered layer by layer,
with a secure reduce-scatter of the gradients in backward.

Counterpart of ``repro/launch/steps.py:55-208``.  Each party (a rank of
the process group) holds its shard of every leaf that
``launch.sharding.party_dim`` splits.  In forward each layer's shards
are all-gathered on entry (public values: the parameters after the last
aggregation); the gather's backward is the secure reduce-scatter of the
layer's cotangent: each party Philox-shares its whole-layer gradient
(``share_gen``, the CUDA kernel on the card), the ``[m, D]`` share stacks
are reduce-scattered, and each party reconstructs only its own slice
(``reconstruct``).  Masked shares are the only cross-party gradient
traffic.

Keys, as the reference's (all uint32 with wraparound): the leaf key
``derive_key(seed, 0xF5D9 ^ tag)`` with ``tag`` the crc32 of the leaf's
path inside its layer group (``['b0_attn']/['attn']/['wq']``), then
``k0 ^ pid·0x9E3779B9 ^ gidx·0x85EBCA6B`` and ``k1 + pid``; ``gidx`` is
the layer index, or ``-1`` (``0xFFFFFFFF``) for the top-level leaves.
A leaf whose per-party slice is not a multiple of 1,024 elements takes
the reference's fallback: a whole secure sum, then the local slice.
The decode at n > 1 is the reference's jitted reciprocal multiply
``x · f32(1/(scale·n))`` (ROADMAP queue 3, finding 2).

Collectives run inside backward, in the same order on every rank: the
layers' backward order, which autograd fixes.  Under ``gloo`` the
``reduce_scatter`` and ``all_gather`` of CUDA tensors are staged
through host memory (``fl.spmd.host_staged``).  The share kernels run
in backward, where grad mode is off.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.field import U32_MASK
from repro_torch.core.fixed_point import DEFAULT_RING
from repro_torch.core.tree import flatten_with_path, path_str, unflatten
from repro_torch.fl.spmd import (_ring_psum_scatter, decode_inv_scale,
                                 host_staged, leaf_seed_tag, party_count,
                                 party_index, round_keys, secure_aggregate)
from repro_torch.kernels.reconstruct import reconstruct
from repro_torch.kernels.share_gen import share_gen
from .sharding import party_dim

#: the reference's tile (128 lanes x 8 rows): the kernel path's alignment
TILE = 128 * 8


def fsdp_keys(seed: int, tag: int, pid: int, gidx: int) -> tuple[int, int]:
    """The share keys of one party's layer leaf (see the module doc)."""
    k0, k1 = round_keys(seed, 0xF5D9 ^ tag)
    k0 = (k0 ^ ((pid * 0x9E3779B9) & U32_MASK)
          ^ (((gidx & U32_MASK) * 0x85EBCA6B) & U32_MASK))
    return k0, (k1 + pid) & U32_MASK


def secure_reduce_scatter_dim(g, dim: int, *, m: int, seed: int, tag: int,
                              gidx: int, group=None):
    """Securely average every party's cotangent ``g`` and return this
    party's slice along ``dim`` (size / n), in ``g``'s dtype."""
    n, pid = party_count(group), party_index(group)
    g2 = g.movedim(dim, 0)
    flat = g2.reshape(-1).to(torch.float32).contiguous()
    per = flat.shape[0] // n
    fp = DEFAULT_RING
    if per % TILE == 0:
        k0, k1 = fsdp_keys(seed, tag, pid, gidx)
        shares = share_gen(flat, m, k0, k1, fp)
        rec = reconstruct(_ring_psum_scatter(shares, group), 1, fp,
                          inv_scale=decode_inv_scale(fp, n))
    else:
        # alignment fallback (small leaves): a whole secure sum, then
        # the local slice
        full = secure_aggregate(flat, scheme="additive", m=m, group=group,
                                seed=seed, round_index=tag, mode="psum")
        rec = full[pid * per:(pid + 1) * per]
    shard = rec.reshape((g2.shape[0] // n,) + tuple(g2.shape[1:]))
    # contiguous, as the replicated layout's aggregate: the clip's norm sums
    # it in memory order
    return shard.movedim(0, dim).to(g.dtype).contiguous()


def all_gather_dim(x, dim: int, group=None):
    """Every party's ``x``, concatenated along ``dim`` in party order."""
    n = party_count(group)
    if n == 1:
        return x.clone()
    src = (x.cpu() if host_staged(x, group) else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class MPCGather(torch.autograd.Function):
    """All-gather in forward; the secure reduce-scatter in backward."""

    @staticmethod
    def forward(ctx, shard, gidx: int, dim: int, m: int, seed: int,
                tag: int, group):
        ctx.spec = (gidx, dim, m, seed, tag, group)
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        gidx, dim, m, seed, tag, group = ctx.spec
        shard_grad = secure_reduce_scatter_dim(
            g.contiguous(), dim, m=m, seed=seed, tag=tag, gidx=gidx,
            group=group)
        return shard_grad, None, None, None, None, None, None


def mpc_gather(shard, gidx: int, dim: int, m: int, seed: int, tag: int,
               group=None):
    return MPCGather.apply(shard, gidx, dim, m, seed, tag, group)


def party_dims(shapes: dict, n_party: int) -> dict:
    """``{path: dim or None}`` of a whole model's leaves (``path`` as in
    ``flatten_with_path``, ``shapes`` the unsplit shapes)."""
    return {path: party_dim(path_str(path), shape, n_party)
            for path, shape in shapes.items()}


def shard_tree(tree, dims: dict, group=None):
    """This party's shard of every leaf of ``tree`` (a copy)."""
    n, pid = party_count(group), party_index(group)
    flat = flatten_with_path(tree)
    out = [leaf if dims[p] is None
           else leaf.chunk(n, dims[p])[pid].clone() for p, leaf in flat]
    return unflatten([p for p, _ in flat], out)


def gather_tree(tree, dims: dict, group=None):
    """The whole leaves of a tree of shards (every party's, gathered)."""
    flat = flatten_with_path(tree)
    out = [leaf if dims[p] is None
           else all_gather_dim(leaf.detach(), dims[p], group)
           for p, leaf in flat]
    return unflatten([p for p, _ in flat], out)


def make_fsdp_transforms(dims: dict, *, m: int, seed: int,
                         gather_dtype=None, group=None):
    """``(layer_transform, top_gather)`` of MPC-FSDP.

    ``dims``: ``party_dims`` of the model.  ``layer_transform(gp, gidx)``
    gathers a layer group's leaves (``gp`` keyed inside the group);
    ``top_gather(params)`` the leaves outside ``layers`` (embedding, LM
    head, final norm, a hybrid's tail) with ``gidx = -1``.
    ``gather_dtype``: a lower precision (e.g. bf16) for the gather of
    float32 leaves; the secure reduce-scatter stays in fixed point.
    """
    # a group leaf's dim: its stacked leaf's, less the layer dim
    group_dims = {p[1:]: d - 1 for p, d in dims.items()
                  if p[0] == "layers" and d is not None}
    top_dims = {p: d for p, d in dims.items()
                if p[0] != "layers" and d is not None}

    def gather(tree, dims_of, gidx):
        flat = flatten_with_path(tree)
        out = []
        for path, leaf in flat:
            dim = dims_of.get(path)
            if dim is None:
                out.append(leaf)
                continue
            src = leaf
            if gather_dtype is not None and leaf.dtype == torch.float32:
                src = leaf.to(gather_dtype)
            full = mpc_gather(src, gidx, dim, m, seed, leaf_seed_tag(path),
                              group)
            out.append(full.to(leaf.dtype))
        return unflatten([p for p, _ in flat], out)

    def layer_transform(gp, gidx: int):
        return gather(gp, group_dims, gidx)

    def top_gather(params):
        top = {k: v for k, v in params.items() if k != "layers"}
        return {**params, **gather(top, top_dims, -1)}

    return layer_transform, top_gather
