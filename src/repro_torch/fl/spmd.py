"""The two-phase MPC protocol as collectives over a process group.

Counterpart of ``repro/fl/spmd.py`` (the scale path).  Each party is one
process of a ``torch.distributed`` group (``group=None``: the default
group; without an initialized group, a world of one, where every
collective is the identity).  Per party:

  encode -> Philox share-gen (CUDA kernel / plain version) ->
  collective share-sum over the parties -> reconstruct -> decode.

Modes, as in the reference:

* ``"psum"`` — the ``[m, D]`` share stack is all-reduced: every party
  sends exactly its m masked shares;
* ``"reduce_scatter"`` — shares are reduce-scattered (each party decodes
  1/n of the vector) and the means all-gathered;
* ``"p2p"`` — n shares per party (m = n), all-reduced;
* ``"plain"`` — a float all-reduce, no MPC.

Where the port's arithmetic differs in form from the reference's, the
bits do not:

* share words are summed in ``int64`` and masked to 32 bits, so the ring
  sum wraps mod 2^32 on every backend (a C++ sum of ``int32`` is signed
  overflow, which no backend promises to wrap);
* the reference pads each vector with encoded zeros to a multiple of
  ``128 · block_rows · n``; padding shifts no Philox counter, so only
  ``reduce_scatter`` pads here (``_pad_len``), to split the vector
  evenly among the parties;
* the reference's decode is jitted, and XLA folds ``/ scale / n`` into
  one multiply by ``f32(1/(scale·n))``; the port passes that factor to
  the reconstruct kernels with ``n = 1`` (``decode_inv_scale``), which
  divides by 1.0 exactly;
* the reference gives every party the same Shamir key; the port keys
  each party as the additive path does (``party_keys``), so no committee
  member learns differences of the parties' updates.  The decoded mean
  is the same, bit for bit.

With the ``gloo`` backend, CUDA tensors are reduced by ``all_reduce``
only: ``reduce_scatter`` and ``all_gather`` stage them through host
memory (``host_staged``).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import philox
from repro_torch.core.field import (U32_MASK, mersenne_reduce, mulhilo32,
                                    u32, words_like)
from repro_torch.core.fixed_point import (DEFAULT_FIELD, DEFAULT_RING,
                                          FixedPointConfig)
from repro_torch.core.tree import flatten_with_path, path_str, unflatten
from repro_torch.kernels import dispatch
from repro_torch.kernels.reconstruct import reconstruct
from repro_torch.kernels.shamir import shamir_reconstruct, shamir_share
from repro_torch.kernels.share_gen import share_gen

LANES = 128
MODES = ("psum", "reduce_scatter", "p2p", "plain")


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def party_index(group=None) -> int:
    """This process's party id in ``group`` (0 in a world of one)."""
    return dist.get_rank(group) if _active() else 0


def party_count(group=None) -> int:
    """Parties in ``group`` (1 without an initialized group)."""
    return dist.get_world_size(group) if _active() else 1


def host_staged(t: torch.Tensor, group=None) -> bool:
    """True when a ``reduce_scatter`` or ``all_gather`` of ``t`` goes
    through host memory: gloo reduces CUDA tensors with all_reduce only."""
    return (party_count(group) > 1 and t.is_cuda
            and dist.get_backend(group) == "gloo")


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if party_count(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def _ring_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every party's words mod 2^32, in ``x``'s carrier."""
    if party_count(group) == 1:
        return x
    w = _all_reduce(u32(x), group)  # u32 returns a new int64 tensor
    return words_like(w & U32_MASK, x)


def _ring_psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``[m, n·c]`` words -> this party's ``[m, c]`` columns, summed over
    the parties mod 2^32."""
    n = party_count(group)
    if n == 1:
        return x
    m, dp = x.shape
    per = dp // n
    w = u32(x).reshape(m, n, per).transpose(0, 1).contiguous()  # [n, m, c]
    staged = host_staged(x, group)
    if staged:
        w = w.cpu()
    out = torch.empty((m, per), dtype=torch.int64, device=w.device)
    dist.reduce_scatter(out, list(w.unbind(0)), group=group)
    return words_like(out.to(x.device) & U32_MASK, x)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every party's ``[c]`` row, concatenated in party order."""
    n = party_count(group)
    if n == 1:
        return x
    src = x.cpu() if host_staged(x, group) else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def field_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Overflow-safe sum of F_p values over the parties: a split-limb sum
    and the reference's Mersenne folds, step for step (:64).

    Each limb is summed in ``int64``, so no limb overflows at any party
    count.  In a world of one the sum is ``x`` itself, and the fold of a
    canonical residue is the identity, so nothing runs.
    """
    if party_count(group) == 1:
        return x
    w = u32(x)
    lo_s = _all_reduce(w & 0xFFFF, group)
    hi_s = _all_reduce(w >> 16, group)
    # total = hi_s * 2^16 + lo_s
    ph, pl = mulhilo32(hi_s, 1 << 16)
    acc = mersenne_reduce(pl)
    # fold the (tiny) high word: 2^32 = 2 (mod p)
    acc = mersenne_reduce(acc + ph + ph)
    return words_like(mersenne_reduce(acc + mersenne_reduce(lo_s)), x)


def _pad_len(d: int, block_rows: int, n_parties: int) -> int:
    tile = LANES * block_rows * n_parties
    return -(-d // tile) * tile


def decode_inv_scale(fp: FixedPointConfig, n: int) -> float:
    """``f32(1/(scale·n))``: the one factor of the reference's jitted
    ``/ scale / n`` (exact for n a power of two, else one rounding)."""
    return float(np.float32(1.0 / (fp.scale * n)))


def party_keys(k0: int, k1: int, hi_base: int) -> tuple[int, int]:
    """The reference's per-party key separation (``_share_dynamic``):
    the party's counter base folded into the round key."""
    k0p = (k0 ^ ((hi_base * 0x9E3779B9) & U32_MASK)) & U32_MASK
    k1p = (k1 + hi_base) & U32_MASK
    return k0p, k1p


def round_keys(seed: int, round_index: int) -> tuple[int, int]:
    """The round's key words as host ints: ``philox.derive_key`` of two
    ints, as one numpy Philox call (the tensor version would be some 300
    tiny host ops per leaf and step)."""
    seed, stream = int(seed), int(round_index)
    words = [seed & U32_MASK, (seed >> 32) & U32_MASK, stream & U32_MASK,
             (stream >> 32) & U32_MASK]
    w = philox.np_philox_4x32(np.array(words, dtype=np.uint64),
                              *philox.DERIVE_KEY)
    return int(w[0]), int(w[1])


def secure_aggregate(flat, *, scheme: str = "additive", m: int = 3,
                     group=None, seed: int = 0, round_index: int = 0,
                     mode: str = "psum", block_rows: int = 64,
                     fp: FixedPointConfig | None = None):
    """Securely average every party's ``flat`` float32 ``[D]``.

    Called by every party of ``group`` with its own ``flat``; returns the
    mean ``[D]`` (identical on every party) on ``flat``'s device.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    n = party_count(group)
    d = flat.shape[0]
    flat = flat.reshape(-1).to(torch.float32).contiguous()
    if flat.data_ptr() % 16:
        # a view off a 16-byte boundary (a chunk of a leaf): the share
        # kernels read rows with D % 4 == 0 as float4
        flat = flat.clone()

    if mode == "plain":
        total = _all_reduce(flat.clone() if n > 1 else flat, group)
        return total / n

    if mode == "p2p":
        m = n
    if scheme not in ("additive", "shamir"):
        raise ValueError(f"unknown scheme {scheme!r}")
    fp = fp or (DEFAULT_RING if scheme == "additive" else DEFAULT_FIELD)
    fp.validate_for_parties(n)
    inv_scale = decode_inv_scale(fp, n)

    pid = party_index(group)
    k0, k1 = round_keys(seed, round_index)
    # per-party key separation via the counter base of the party (the
    # reference's hi_base), folded into the round key
    hi_base = (pid * 64) & U32_MASK

    if scheme == "additive":
        if mode == "reduce_scatter":
            # pad so the columns divide evenly among the parties
            dp = _pad_len(d, block_rows, n)
            flat_p = torch.nn.functional.pad(flat, (0, dp - d))
            shares = _share_dynamic(flat_p, m, k0, k1, fp, hi_base)
            scat = _ring_psum_scatter(shares, group)
            rec = _all_gather(reconstruct(scat, 1, fp, inv_scale=inv_scale),
                              group)
        else:
            shares = _share_dynamic(flat, m, k0, k1, fp, hi_base)
            rec = reconstruct(_ring_psum(shares, group), 1, fp,
                              inv_scale=inv_scale)
        return rec[:d]

    k0p, k1p = party_keys(k0, k1, hi_base)
    shares = shamir_share(flat, m, k0p, k1p, fp)
    summed = field_psum(shares, group)
    return shamir_reconstruct(summed, 1, fp, inv_scale=inv_scale)


def _share_dynamic(flat_p, m, k0, k1, fp, hi_base):
    """share_gen with the party's counter base folded into the key and
    ``hi_base=0``, as the reference does for its static kernel argument."""
    k0p, k1p = party_keys(k0, k1, hi_base)
    return share_gen(flat_p, m, k0p, k1p, fp, hi_base=0)


def leaf_seed_tag(path) -> int:
    """Deterministic per-leaf seed tweak from the leaf's key path.

    ``zlib.crc32`` of the path as the reference spells it
    (``['layers']/['b0_attn']/['attn']/['wq']``), the same on every party
    and across restarts — never Python ``hash()``.
    """
    return zlib.crc32(path_str(path).encode("utf-8")) & 0x7FFFFFFF


def secure_aggregate_tree(tree, **kw):
    """Secure-aggregate a nested dict of tensors **leaf-wise**.

    Leaves are visited in the reference's order, and each gets the seed
    ``seed ^ leaf_seed_tag(path)``.  ``chunk_elems=`` caps the elements
    per aggregation call (default 2^30, the reference's): a longer leaf
    is aggregated in chunks, chunk ``ci`` with the seed tweak
    ``^ (0x51ED << 8) ^ ci`` of the reference.
    """
    chunk_elems = kw.pop("chunk_elems", None)
    max_chunk = int(chunk_elems) if chunk_elems else (1 << 30)
    flat = flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        seed_leaf = (kw.get("seed", 0) ^ leaf_seed_tag(path)) & 0x7FFFFFFF
        kw_leaf = dict(kw, seed=seed_leaf)
        fl = leaf.reshape(-1).to(torch.float32)
        if fl.shape[0] <= max_chunk:
            mean = secure_aggregate(fl, **kw_leaf)
        else:
            pieces = []
            for ci, off in enumerate(range(0, fl.shape[0], max_chunk)):
                kw_c = dict(kw_leaf,
                            seed=(seed_leaf ^ (0x51ED << 8) ^ ci)
                            & 0x7FFFFFFF)
                pieces.append(secure_aggregate(fl[off:off + max_chunk],
                                               **kw_c))
            mean = torch.cat(pieces)
        out.append(mean.reshape(leaf.shape))
    return unflatten([p for p, _ in flat], out)


def elect_committee_spmd(n: int, m: int, b: int, seed: int, group=None,
                         device="cuda"):
    """Alg. 2 as one small sum over the parties: the committee ids,
    highest tally first, lowest id on ties.

    ``device``: where the votes are drawn and summed — the card unless
    asked for the CPU (gloo sums CUDA tensors with ``all_reduce`` too).
    """
    device = dispatch.resolve_device(device)
    pid = party_index(group)
    k0, k1 = philox.derive_key(seed, 0x0C0FFEE)
    bits = philox.random_bits(b, int(k0) ^ pid, int(k1), device=device)
    votes = bits % n
    total = _ring_psum(votes, group) % n
    tally = torch.bincount(total, minlength=n)
    # deterministic top-m with lowest-index tie-break
    score = tally * n - torch.arange(n, device=tally.device)
    return torch.topk(score, m).indices
