"""Secure aggregation of flat updates — the paper's technique as a library.

Counterpart of ``repro/core/aggregation.py``.  ``SecureAggregator``
encodes each party's flat float32 update, splits it into shares,
sums the shares per committee member and reconstructs the decoded
FedAvg mean.  The four hot steps go through the kernel wrappers
(``kernels.share_gen``, ``kernels.shamir``, ``kernels.reconstruct``),
so on the card they run the CUDA kernels and on the CPU their plain
versions; both give the reference's bits.

Words are ``int64`` on the CPU and ``int32`` bit patterns on the card
(``core.field``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.kernels import dispatch
from . import additive, shamir
from .field import MERSENNE_P, U32_MASK, fadd, to_i32, words_like
from .fixed_point import DEFAULT_FIELD, DEFAULT_RING, FixedPointConfig, true_div
from .philox import derive_key

SCHEME_ADDITIVE = "additive"
SCHEME_SHAMIR = "shamir"

#: Default element-chunk size of the streaming aggregation path.
DEFAULT_CHUNK_ELEMS = 1 << 20

#: Chunk boundaries align to the Philox counter blocks (4 words); 128
#: keeps the reference's alignment, so both packages accept the same
#: chunk sizes and ``elem_base // 4`` is exact for every chunk.
CHUNK_ALIGN = 128


def _check_chunk_elems(chunk_elems: int) -> int:
    chunk_elems = int(chunk_elems)
    if chunk_elems < CHUNK_ALIGN or chunk_elems % CHUNK_ALIGN != 0:
        raise ValueError(
            f"chunk_elems={chunk_elems} must be a positive multiple of "
            f"{CHUNK_ALIGN} (Philox counter alignment)")
    return chunk_elems


def _leaves(tree, prefix=()):
    """(path, tensor) leaves of nested dicts in sorted-key order — the
    order ``jax.tree_util`` flattens a dict in, so every element keeps
    its reference position (and with it its Philox counter)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, torch.as_tensor(tree)


def flatten(tree):
    """Nested dict of tensors -> (flat float32 vector, unflatten fn)."""
    leaves = list(_leaves(tree))
    paths = [p for p, _ in leaves]
    shapes = [t.shape for _, t in leaves]
    flat = (torch.cat([t.reshape(-1).to(torch.float32) for _, t in leaves])
            if leaves else torch.zeros((0,), dtype=torch.float32))

    def unflatten(vec):
        out: dict = {}
        off = 0
        for path, shape in zip(paths, shapes):
            size = int(np.prod(shape)) if len(shape) else 1
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = vec[off:off + size].reshape(shape)
            off += size
        return out

    return flat, unflatten


@dataclasses.dataclass(frozen=True)
class SecureAggregator:
    """Scheme + codec bundle on one device.

    Attributes:
      scheme: ``"additive"`` or ``"shamir"``.
      m: shares per party (committee size; ``n`` in P2P mode).
      fp: fixed-point codec (its algebra must match the scheme).
      shamir_degree: polynomial degree (default ``m - 1``).
      device: where the shares are made and summed; the card unless
        ``"cpu"`` is asked for.
    """

    scheme: str = SCHEME_ADDITIVE
    m: int = 3
    fp: FixedPointConfig | None = None
    shamir_degree: int | None = None
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.scheme not in (SCHEME_ADDITIVE, SCHEME_SHAMIR):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.fp is None:
            object.__setattr__(
                self, "fp",
                DEFAULT_RING if self.scheme == SCHEME_ADDITIVE
                else DEFAULT_FIELD)
        want = "ring" if self.scheme == SCHEME_ADDITIVE else "field"
        if self.fp.algebra != want:
            raise ValueError(
                f"scheme {self.scheme} needs {want} codec, got "
                f"{self.fp.algebra}")
        object.__setattr__(self, "device",
                           dispatch.resolve_device(self.device))

    def _flats(self, flats) -> torch.Tensor:
        return torch.as_tensor(flats, dtype=torch.float32).to(
            self.device).contiguous()

    def _ids(self, party_ids) -> torch.Tensor:
        """Party ids as ``int64`` on the aggregator's device."""
        if not isinstance(party_ids, torch.Tensor):
            party_ids = torch.as_tensor(np.asarray(party_ids, dtype=np.int64))
        return party_ids.to(self.device, torch.int64)

    # -- party side -----------------------------------------------------

    def encode(self, flats):
        """float32 updates -> ``int64`` codewords of the scheme's codec."""
        return self.fp.encode(self._flats(flats))

    def party_key_words(self, seed: int, party_ids,
                        round_index: int = 0) -> torch.Tensor:
        """``int64`` keys ``[l, 2]`` of the parties' streams on the
        aggregator's device.

        Party ``i`` keys its stream with ``derive_key(seed,
        (round_index << 24) | i)``, passed as the ``(lo, hi)`` word pair
        so the high word of a round index >= 256 is kept.
        """
        ids = self._ids(party_ids)
        stream_lo = ((round_index << 24) & U32_MASK) | ids
        stream_hi = (round_index << 24) >> 32
        k0, k1 = derive_key(seed, (stream_lo, stream_hi))
        return torch.stack([k0, k1], dim=1)

    def _party_keys(self, seed: int, ids: torch.Tensor,
                    round_index: int) -> torch.Tensor:
        """``party_key_words`` in the carrier of the aggregator's device,
        derived where the shares are made."""
        keys = self.party_key_words(seed, ids, round_index)
        if self.device.type == "cuda":
            keys = to_i32(keys).contiguous()
        return keys

    def make_shares_batch(self, flats, *, seed: int, party_ids,
                          round_index: int = 0, elem_base: int = 0):
        """All parties' share stacks: ``[l, D] -> [l, m, D]`` words.

        ``elem_base``: offset of this element chunk in the whole
        codeword (a multiple of ``CHUNK_ALIGN``); the chunk then draws
        the counters it occupies in the whole vector.
        """
        keys = self._party_keys(seed, self._ids(party_ids), round_index)
        return self._shares(self._flats(flats), keys, elem_base)

    def _shares(self, flats: torch.Tensor, keys: torch.Tensor,
                elem_base: int):
        from repro_torch.kernels.shamir import shamir_share_batch
        from repro_torch.kernels.share_gen import share_gen_batch
        elem_base = int(elem_base)
        if elem_base % CHUNK_ALIGN != 0 or elem_base < 0:
            raise ValueError(
                f"elem_base={elem_base} must be a non-negative multiple "
                f"of {CHUNK_ALIGN} (counter alignment)")
        if self.scheme == SCHEME_ADDITIVE:
            return share_gen_batch(flats, self.m, keys, self.fp,
                                   counter_base=elem_base // 4)
        return shamir_share_batch(flats, self.m, keys, self.fp,
                                  degree=self.shamir_degree,
                                  counter_base=elem_base // 4)

    def sum_shares_batch(self, flats, *, seed: int, party_ids,
                         round_index: int = 0, chunk: int = 2048,
                         elem_base: int = 0):
        """Streaming share-stack sum: ``[l, D] -> [m, D]`` member sums.

        Shares are made in party chunks of ``chunk`` and folded into the
        ring/field sum as they come, so peak memory is
        ``O(chunk * m * D)``.  ``flats`` may also be a callable
        ``(p_lo, p_hi) -> [p, D]`` block producer.
        """
        keys = self._party_keys(seed, self._ids(party_ids), round_index)
        return self._sum_shares(flats, keys, chunk, elem_base)

    def _sum_shares(self, flats, keys: torch.Tensor, chunk: int,
                    elem_base: int):
        """``sum_shares_batch`` with every party's key derived up front:
        one derivation per call, none per chunk."""
        l = int(keys.shape[0])
        if callable(flats):
            get = flats
        else:
            flats = self._flats(flats)
            if flats.shape[0] != l:
                raise ValueError(
                    f"{flats.shape[0]} updates but {l} party ids")

            def get(lo, hi):
                return flats[lo:hi]

        if l == 0:
            raise ValueError("no party updates to sum")
        acc = None
        for off in range(0, l, chunk):
            hi = min(off + chunk, l)
            block = self._flats(get(off, hi))
            if block.ndim != 2 or block.shape[0] != hi - off:
                raise ValueError(
                    f"party block source returned {tuple(block.shape)}, "
                    f"expected ({hi - off}, D)")
            stacks = self._shares(block, keys[off:hi], elem_base)
            part = self._party_residues(stacks)
            if acc is None:
                acc = part
            elif self.scheme == SCHEME_ADDITIVE:
                acc = (acc + part) & U32_MASK
            else:
                acc = fadd(acc, part)
        return words_like(acc, stacks)

    def aggregate_stream(self, flats, *, seed: int, party_ids,
                         round_index: int = 0,
                         chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                         party_chunk: int = 2048, d: int | None = None,
                         member_rows=None,
                         points: tuple[int, ...] | None = None,
                         n: int | None = None):
        """Streaming chunked secure aggregation: ``[l, D] -> [D]`` mean.

        Each element chunk of ``chunk_elems`` goes through
        ``sum_shares_batch -> reconstruct_mean``; chunk ``c`` draws the
        counters it occupies in the whole vector, so the result equals
        the whole-vector path bit for bit.

        ``flats`` may be ``[l, D]`` or a callable
        ``source(p_lo, p_hi, e_lo, e_hi) -> [p, e]`` (then ``d`` is
        required).  ``member_rows``/``points`` select the live committee
        rows (Shamir sub-threshold path); ``n`` is the divisor of the
        mean (default ``l``).
        """
        chunk_elems = _check_chunk_elems(chunk_elems)
        keys = self._party_keys(seed, self._ids(party_ids), round_index)
        l = int(keys.shape[0])
        if callable(flats):
            if d is None:
                raise ValueError("callable flats requires d=")
            source = flats
        else:
            flats = self._flats(flats)
            if flats.shape[0] != l:
                raise ValueError(
                    f"{flats.shape[0]} updates but {l} party ids")
            if d is None:
                d = int(flats.shape[1])

            def source(p_lo, p_hi, e_lo, e_hi):
                return flats[p_lo:p_hi, e_lo:e_hi]

        n = l if n is None else int(n)
        out = []
        for e_lo in range(0, d, chunk_elems):
            e_hi = min(e_lo + chunk_elems, d)

            def col_block(p_lo, p_hi, e_lo=e_lo, e_hi=e_hi):
                block = self._flats(source(p_lo, p_hi, e_lo, e_hi))
                if tuple(block.shape) != (p_hi - p_lo, e_hi - e_lo):
                    raise ValueError(
                        f"source returned {tuple(block.shape)}, expected "
                        f"{(p_hi - p_lo, e_hi - e_lo)}")
                return block

            acc = self._sum_shares(col_block, keys, party_chunk, e_lo)
            if member_rows is not None:
                acc = acc[list(member_rows)]
            out.append(self.reconstruct_mean(acc, n, points=points))
        return out[0] if len(out) == 1 else torch.cat(out)

    # -- committee / reconstruction side ---------------------------------

    def reduce_party_shares(self, stacked):
        """Sum per-party share stacks ``[l, m, D] -> [m, D]`` (Alg. 3
        l.15) in the carrier of ``stacked``.

        An ``int64`` sum over the party axis, then ``mod 2^32`` (ring)
        or ``mod p`` (field): exact below 2^31 parties, and equal to the
        reference's order-independent modular sum.  int32 bit patterns
        sum as signed values, which is the same residue mod 2^32, and
        field words are below 2^31, so they are non-negative either way.
        """
        return words_like(self._party_residues(stacked), stacked)

    def _party_residues(self, stacked) -> torch.Tensor:
        """The party sum of ``reduce_party_shares`` as ``int64`` words."""
        total = stacked.sum(dim=0, dtype=torch.int64)
        if self.scheme == SCHEME_ADDITIVE:
            return total & U32_MASK
        return total % MERSENNE_P

    def reconstruct_sum(self, member_sums, points: tuple[int, ...] | None
                        = None):
        """Combine committee members' sums ``[k, D] -> [D]`` codewords
        (``int64``); ``points`` for Shamir sub-threshold sets."""
        if self.scheme == SCHEME_ADDITIVE:
            if points is not None:
                raise ValueError(
                    "additive reconstruction needs all m shares; "
                    "points= is a Shamir-only argument")
            return additive.reconstruct(member_sums)
        return shamir.reconstruct(member_sums, points=points)

    def reconstruct_mean(self, member_sums, n: int,
                         points: tuple[int, ...] | None = None):
        """Fused reconstruct + decode: ``[k, D] -> [D]`` float32 mean.

        As in the reference, the kernel decodes the *sum* (n = 1, an
        exact power-of-two unscale) and the mean is one eager IEEE
        division by ``n`` after it.
        """
        from repro_torch.kernels.reconstruct import reconstruct
        from repro_torch.kernels.shamir import shamir_reconstruct
        if points is not None and self.scheme == SCHEME_ADDITIVE:
            raise ValueError(
                "additive reconstruction needs all m shares; "
                "points= is a Shamir-only argument")
        sums = member_sums.to(self.device).contiguous()
        if self.scheme == SCHEME_ADDITIVE:
            out = reconstruct(sums, 1, self.fp)
        else:
            out = shamir_reconstruct(sums, 1, self.fp, points=points)
        return true_div(out, n)

    # -- one-shot reference path -----------------------------------------

    def aggregate_reference(self, flats, *, seed: int, round_index: int = 0):
        """Share -> sum -> reconstruct -> mean for a list of flat updates."""
        n = len(flats)
        self.fp.validate_for_parties(n)
        member_sums = self.sum_shares_batch(
            torch.stack([torch.as_tensor(f) for f in flats]), seed=seed,
            party_ids=np.arange(n), round_index=round_index)
        return self.reconstruct_mean(member_sums, n)


def secure_mean_pytrees(trees, agg: SecureAggregator, *, seed: int,
                        round_index: int = 0):
    """Securely average a list of parameter dicts (reference path)."""
    flats_unf = [flatten(t) for t in trees]
    mean = agg.aggregate_reference([f for f, _ in flats_unf], seed=seed,
                                   round_index=round_index)
    return flats_unf[0][1](mean)
