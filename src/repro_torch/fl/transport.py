"""Transport layer — who sends what to whom, per phase, in the simulation.

Counterpart of the counting transports of ``repro/fl/transport.py``:

* ``PlainTransport``    — un-encrypted FedAvg, l·(l−1) messages of s;
* ``P2PTransport``      — Alg. 1, 2·l·(l−1) messages of s (Eqs. 1–2);
* ``TwoPhaseTransport`` — Phase I election (Alg. 2, 2·n·(n−1) messages
  of b per election round, Eqs. 3–4) and Phase II (Alg. 3: l·m uploads,
  m−1 chain exchanges, n broadcasts, Eqs. 5–6), with party dropouts and
  Shamir committee dropouts; with ``vss=True`` the malicious-secure
  round: Feldman commitments, member-row verification, blame, eviction
  and re-election, and the per-dealer norm audit (DESIGN.md §10–11);
  with ``cohort=c`` each round runs over a seeded cohort of ``c``
  parties sampled from the registry of ``n`` (DESIGN.md §12);
* ``repro_torch.net.WireTransport`` (``backend="wire"``) — the real
  multi-process deployment over TCP, with party workers on the device.

The party-side math runs through ``SecureAggregator`` on the
transport's device.  ``compression=`` (top-k with per-party error
feedback, ``core.compression``) sparsifies each upload before it is
shared; the residuals stay on the transport's device, keyed by party id.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import committee as committee_mod
from repro_torch.core import philox, vss
from repro_torch.core.aggregation import SecureAggregator, _check_chunk_elems
from repro_torch.core.compression import (CompressionConfig,
                                          compress_topk_batch,
                                          compressed_size)
from repro_torch.core.field import to_field, to_i32, words_like
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.verify_shares import verify_shares
from .cohort import sample_cohort
from .faults import (DEALER_TAMPER_MODES, POISON_SCALE, TAMPER_FLIP_MASK,
                     TAMPER_SEED_XOR, resolve_outcome, update_norm)

__all__ = ["Network", "P2PTransport", "PhaseStats", "PlainTransport",
           "SPMDTransport", "Transport", "TwoPhaseTransport",
           "check_kernel_backend", "make_transport"]

#: the reference's refusal of top-k on the wire (``fl/simulation.py``)
WIRE_TOPK_REFUSED = ("top-k compression is not implemented on the wire "
                     "backend yet; drop compression= or use backend='sim'")


def check_kernel_backend(kernel_backend) -> None:
    """The reference's ``kernel_backend`` picks a Pallas dispatch mode;
    the port has one rule instead (the tensor's device picks the kernel
    or its plain version), so only ``None`` is accepted."""
    if kernel_backend is not None:
        raise ValueError(
            f"kernel_backend={kernel_backend!r} has no meaning in the "
            "PyTorch port: the tensor's device picks the path (the CUDA "
            "kernel on the card, its plain version on the CPU); leave it "
            "None")


# ---------------------------------------------------------------------------
# Message-counting network
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseStats:
    msg_num: int = 0
    msg_size: int = 0          # in elements, paper convention

    def add_batch(self, count: int, size: int):
        """Count ``count`` messages of ``size`` elements each."""
        if count < 0:
            raise ValueError(
                f"message count must be non-negative, got {count}")
        if size <= 0:
            raise ValueError(
                f"message size must be positive, got {size}")
        self.msg_num += count
        self.msg_size += count * size


class Network:
    """Counts every point-to-point message, per phase."""

    def __init__(self):
        self.phases: dict[str, PhaseStats] = {}

    def send_batch(self, count: int, n_elems: int, phase: str):
        """``count`` messages of ``n_elems`` each, in one call."""
        self.phases.setdefault(phase, PhaseStats()).add_batch(count, n_elems)

    def absorb(self, msg_num: int, msg_size: int, phase: str):
        """Fold a remote meter digest into the counters: ``msg_size`` is
        the *total* element count of the digest's ``msg_num`` messages
        (the tree relay's home members meter their regions' uploads and
        the coordinator replays the digests here, DESIGN.md §13)."""
        if msg_num < 0 or msg_size < 0:
            raise ValueError(
                f"meter digest must be non-negative, got "
                f"({msg_num}, {msg_size})")
        if (msg_num == 0) != (msg_size == 0):
            raise ValueError(
                f"inconsistent meter digest ({msg_num} messages, "
                f"{msg_size} elements): zero-size messages are never "
                "counted, so both are zero or neither is")
        if msg_num == 0:
            return
        st = self.phases.setdefault(phase, PhaseStats())
        st.msg_num += msg_num
        st.msg_size += msg_size

    def stats(self, phase: str | None = None) -> PhaseStats:
        if phase is not None:
            return self.phases.get(phase, PhaseStats())
        total = PhaseStats()
        for p in self.phases.values():
            total.msg_num += p.msg_num
            total.msg_size += p.msg_size
        return total


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class Transport(abc.ABC):
    """One aggregation protocol: wire behaviour + party-side dataflow."""

    protocol: str

    def elect(self, round_index: int = 0):
        """Run Phase I if the protocol has one; returns the committee."""
        return None

    @abc.abstractmethod
    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        """Aggregate the live parties' flat updates ``[l, D]`` into their
        mean.  ``party_ids`` are the original ids of the rows (party
        ``i`` always masks with its own stream); default ``0..l-1``."""


class _SimTransport(Transport):
    """Shared state of the counting transports.

    ``chunk``: party-chunk size of the share engine; ``chunk_elems``:
    element-chunk size of the streaming path (``None`` keeps the
    whole vector; the bits are the same either way).
    """

    def __init__(self, n: int, *, m: int = 3, scheme: str = "additive",
                 seed: int = 0, b: int = 10, net: Network | None = None,
                 fp: FixedPointConfig | None = None,
                 shamir_degree: int | None = None, chunk: int = 2048,
                 chunk_elems: int | None = None, device="cuda",
                 compression: CompressionConfig | None = None):
        self.n = n
        self.m = m
        self.b = b
        self.seed = seed
        self.scheme = scheme
        self.fp = fp
        self.shamir_degree = shamir_degree
        self.chunk = chunk
        self.chunk_elems = (None if chunk_elems is None
                            else _check_chunk_elems(chunk_elems))
        self.device = dispatch.resolve_device(device)
        self.compression = compression
        #: party id -> row of ``_err_rows`` (each party's top-k residual)
        self._err_slot: dict[int, int] = {}
        self._err_rows: torch.Tensor | None = None
        self.net = net if net is not None else Network()

    def _as_batch(self, flats) -> torch.Tensor:
        if isinstance(flats, (list, tuple)):
            flats = torch.stack([torch.as_tensor(f) for f in flats])
        return torch.as_tensor(flats, dtype=torch.float32).to(
            self.device).contiguous()

    @staticmethod
    def _ids(party_ids, l: int) -> list[int]:
        if party_ids is None:
            return list(range(l))
        ids = [int(i) for i in party_ids]
        if len(ids) != l:
            raise ValueError(f"{l} updates but {len(ids)} party ids")
        return ids

    # -- compression (top-k + error feedback) -----------------------------

    def _compress(self, flats, ids):
        """Sparsify the live parties' updates; returns ``(dense flats,
        wire size)``.

        The wire size is what one upload costs in elements (``2k``: k
        values and k index words); partial sums and broadcasts stay at
        the dense ``s`` (``costmodel.phase2_msg_size_topk``).  Each
        party's residual changes here, so callers run every check that
        can raise first: a refused round must leave the residuals as it
        leaves the counters.
        """
        s = int(flats.shape[1])
        if self.compression is None or not self.compression.enabled:
            return flats, s
        rows = self._err_index(ids, s)
        dense, new_err = compress_topk_batch(flats, self.compression,
                                             self._err_rows[rows])
        self._err_rows[rows] = new_err
        return dense, compressed_size(s, self.compression)

    def _err_index(self, ids, s: int) -> torch.Tensor:
        """Rows of ``_err_rows`` for ``ids``; a party seen for the first
        time gets a zero row."""
        fresh = [i for i in dict.fromkeys(ids) if i not in self._err_slot]
        if self._err_rows is not None and self._err_rows.shape[1] != s:
            raise ValueError(f"updates of {s} elements; the residuals "
                             f"hold {self._err_rows.shape[1]}")
        if fresh:
            base = 0 if self._err_rows is None else self._err_rows.shape[0]
            zeros = torch.zeros((len(fresh), s), dtype=torch.float32,
                                device=self.device)
            self._err_rows = zeros if self._err_rows is None else \
                torch.cat([self._err_rows, zeros])
            self._err_slot.update((i, base + j) for j, i in enumerate(fresh))
        return torch.tensor([self._err_slot[i] for i in ids],
                            dtype=torch.int64, device=self.device)

    def error_states(self, party_ids) -> torch.Tensor:
        """The top-k residuals ``[l, s]`` of ``party_ids`` (the reference's
        ``_err_state`` rows); a party that never uploaded has none."""
        missing = [i for i in party_ids if int(i) not in self._err_slot]
        if missing:
            raise KeyError(f"parties {missing} have no residual yet")
        return self._err_rows[[self._err_slot[int(i)] for i in party_ids]]

    def _aggregator(self, m: int) -> SecureAggregator:
        return SecureAggregator(scheme=self.scheme, m=m, fp=self.fp,
                                shamir_degree=self.shamir_degree,
                                device=self.device)

    def _secure_mean(self, agg: SecureAggregator, flats, ids, round_index,
                     member_rows=None, points=None):
        """Party-side share math through ``agg``; the l-party mean."""
        l = int(flats.shape[0])
        if self.chunk_elems is not None:
            return agg.aggregate_stream(
                flats, seed=self.seed, party_ids=ids,
                round_index=round_index, chunk_elems=self.chunk_elems,
                party_chunk=self.chunk, member_rows=member_rows,
                points=points)
        member_sums = agg.sum_shares_batch(
            flats, seed=self.seed, party_ids=ids,
            round_index=round_index, chunk=self.chunk)
        if member_rows is not None:
            member_sums = member_sums[list(member_rows)]
        return agg.reconstruct_mean(member_sums, l, points=points)


class PlainTransport(_SimTransport):
    """Un-encrypted FedAvg exchange (the paper's "withoutMPC" curve)."""

    protocol = "plain"

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        flats = self._as_batch(flats)
        l = int(flats.shape[0])
        ids = self._ids(party_ids, l)
        flats, wire_s = self._compress(flats, ids)
        # every live party sends its (sparsified) update to every other
        self.net.send_batch(l * (l - 1), wire_s, "plain")
        return flats.mean(dim=0)


class P2PTransport(_SimTransport):
    """Alg. 1 on the whole flattened model: l−1 share messages and l−1
    partial-sum messages per party ⇒ 2·l·(l−1) messages of size s."""

    protocol = "p2p"

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        flats = self._as_batch(flats)
        l, s = int(flats.shape[0]), int(flats.shape[1])
        ids = self._ids(party_ids, l)
        agg = self._aggregator(l)
        # every check that can raise comes before _compress
        agg.fp.validate_for_parties(l)
        flats, wire_s = self._compress(flats, ids)
        self.net.send_batch(l * (l - 1), wire_s, "p2p")  # shares V(i, j)
        # partial sums S(i) live on the union support: dense size s
        self.net.send_batch(l * (l - 1), s, "p2p")
        return self._secure_mean(agg, flats, ids, round_index)


class TwoPhaseTransport(_SimTransport):
    """The paper's two-phase protocol (Algs. 2 + 3).

    Phase I: committee election as a P2P additive MPC on b-vectors.
    Phase II: share upload (l·m) → committee chain partial-sum exchange
    (m−1) → broadcast (n) ⇒ (l·m + m − 1 + n) messages of size s.
    Committee-member dropouts (``committee_dropout``) are tolerated by
    the Shamir scheme while the live members hold ``degree + 1``
    evaluation points (sub-threshold reconstruction).

    Malicious security (Shamir only): with ``vss=True`` every party also
    sends Feldman commitments to each member (``phase2_commit``), the
    member rows are verified against the dealers' aggregate commitments
    (``kernels.verify_shares``), and a member whose row fails is blamed,
    evicted from later elections and left out of the reconstruction —
    the mean is the honest one.  ``reelect_each_round`` re-runs Alg. 2
    every round, without the evicted and with reputation weights.
    ``norm_bound`` adds the per-dealer audit: every dealer's rows are
    checked against its own commitments, its update is reconstructed,
    and a dealer whose L2 norm exceeds the bound is blamed and dropped
    from the mean (``phase2_audit``).  ``dealer_tamper`` injects the
    dealer adversary, ``{party: (mode, round)}``; ``committee_tamper=``
    of ``aggregate`` injects the member adversary, ``{member: mode}``.

    ``cohort=c`` turns on cohort-sampled rounds (DESIGN.md §12): ``n``
    is the registry, and each round runs over a cohort of ``c`` parties
    that ``fl.cohort.sample_cohort`` draws from the registry minus the
    evicted (further restricted by ``eligible=``).  Cohort mode elects
    every round, over the round's cohort (``elect_among``, 2·c·(c−1)
    messages of b a subround), and the aggregate still reaches all
    ``n`` parties, as ``costmodel.summary_cohort`` counts.
    """

    protocol = "two_phase"

    def __init__(self, n: int, *, vss: bool = False,
                 reelect_each_round: bool = False,
                 norm_bound: float | None = None,
                 dealer_tamper: dict | None = None,
                 cohort: int | None = None, **kw):
        super().__init__(n, **kw)
        if cohort is not None:
            cohort = int(cohort)
            if not 1 <= cohort <= n:
                raise ValueError(
                    f"cohort={cohort} must be in 1..n={n} (the cohort "
                    "is sampled from the registered population)")
            if cohort < self.m:
                raise ValueError(
                    f"cohort={cohort} cannot seat a committee of "
                    f"m={self.m}")
        self.cohort = cohort
        #: the current round's sampled cohort (global ids, sorted)
        self.cohort_ids: tuple[int, ...] | None = None
        if vss and self.scheme != "shamir":
            raise ValueError(
                "verifiable secret sharing needs the Shamir scheme "
                "(commitments verify polynomial evaluations); "
                f"got scheme={self.scheme!r}")
        if vss and self.compression is not None \
                and self.compression.enabled:
            raise ValueError(
                "vss=True with top-k compression is not supported yet "
                "— commitments would bind the densified update")
        if norm_bound is not None:
            norm_bound = float(norm_bound)
            if norm_bound <= 0:
                raise ValueError(
                    f"norm_bound must be positive, got {norm_bound}")
            if not vss:
                raise ValueError(
                    "norm_bound needs vss=True — the dealer audit checks "
                    "per-dealer rows against their commitments "
                    "(DESIGN.md §11)")
        self.norm_bound = norm_bound
        self.dealer_tamper: dict[int, tuple[str, int]] = {}
        for pid, (mode, rnd) in (dealer_tamper or {}).items():
            if mode not in DEALER_TAMPER_MODES:
                raise ValueError(
                    f"unknown dealer tamper mode {mode!r}; expected one "
                    f"of {DEALER_TAMPER_MODES}")
            if mode == "malformed" and not vss:
                raise ValueError(
                    "dealer_tamper mode 'malformed' needs vss=True — "
                    "without commitments a corrupted share stream is "
                    "undetectable and the round would silently return "
                    "garbage")
            if not 0 <= int(pid) < n:
                raise ValueError(
                    f"dealer_tamper names out-of-range party {pid} "
                    f"(valid ids are 0..{n - 1})")
            self.dealer_tamper[int(pid)] = (str(mode), int(rnd))
        self.vss = vss
        self.reelect_each_round = reelect_each_round
        self.committee: tuple[int, ...] | None = None
        #: members and dealers caught cheating (never eligible again)
        self.evicted: set[int] = set()
        #: per-party election weight (1.0 default; 0 when evicted, halved
        #: per dropout under per-round re-election)
        self.reputation: dict[int, float] = {}
        self.last_outcome = None
        self._elected_round: int | None = None
        self.agg = self._aggregator(self.m)

    @property
    def degree(self) -> int:
        return (self.agg.shamir_degree
                if self.agg.shamir_degree is not None else self.m - 1)

    # -- Phase I ----------------------------------------------------------

    def elect(self, round_index: int = 0,
              eligible=None) -> tuple[int, ...]:
        """Alg. 2 with counted messages (P2P MPC on b-vectors), without
        the evicted parties and weighted by reputation.

        In cohort mode the voters are the round's cohort, sampled from
        ``eligible`` (default: the registry) minus the evicted; outside
        it ``eligible`` is ignored.
        """
        if self.cohort is not None:
            pool = (set(range(self.n)) if eligible is None
                    else {int(i) for i in eligible})
            pool -= self.evicted
            self.cohort_ids = sample_cohort(pool, self.cohort, self.seed,
                                            round_index, device=self.device)
            result = committee_mod.elect_among(
                self.cohort_ids, self.m, self.b, self.seed + round_index,
                exclude=self.evicted, reputation=self.reputation or None,
                device=self.device)
            voters = len(self.cohort_ids)
        else:
            result = committee_mod.elect(self.n, self.m, self.b,
                                         self.seed + round_index,
                                         exclude=self.evicted,
                                         reputation=self.reputation or None,
                                         device=self.device)
            voters = self.n
        # each election round is one P2P additive MPC exchange of
        # b-element messages (shares + partial sums)
        self.net.send_batch(result.rounds * 2 * voters * (voters - 1),
                            self.b, "phase1")
        self.committee = result.committee
        self._elected_round = round_index
        return result.committee

    # -- Phase II ---------------------------------------------------------

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0,
                  committee_dropout: Sequence[int] = (),
                  committee_tamper: dict | None = None, eligible=None):
        if self.cohort is not None:
            # cohort mode elects every round, over the round's cohort
            if self._elected_round != round_index:
                self.elect(round_index, eligible=eligible)
        elif self.reelect_each_round \
                and self._elected_round != round_index:
            # per-round re-election: Alg. 2 again, without the evicted
            # members and with reputation-weighted scores
            self.elect(round_index)
        elif self.committee is None:
            self.elect(round_index)
        if committee_tamper and not self.vss:
            raise ValueError(
                "committee_tamper needs vss=True — without commitments "
                "a tampered partial sum is undetectable and the round "
                "would silently return garbage")
        flats = self._as_batch(flats)
        l, s = int(flats.shape[0]), int(flats.shape[1])
        if party_ids is None and self.cohort is not None:
            party_ids = self.cohort_ids
        ids = self._ids(party_ids, l)
        if self.cohort is not None:
            stray = set(ids) - set(self.cohort_ids)
            if stray:
                raise ValueError(
                    f"party_ids {sorted(stray)} are not in round "
                    f"{round_index}'s sampled cohort "
                    f"{self.cohort_ids} — only cohort members upload")
        # the committee sums l encodings — same headroom bound as P2P
        self.agg.fp.validate_for_parties(l)
        com = self.committee
        dropped = set(int(i) for i in committee_dropout)
        live_pos = [w for w, member in enumerate(com)
                    if member not in dropped]
        m_live = len(live_pos)
        # validate before touching the counters
        if m_live < self.m:
            if self.scheme != "shamir":
                raise ValueError(
                    "additive sharing cannot reconstruct with committee "
                    f"members {sorted(dropped)} down — use scheme='shamir' "
                    "with degree < m-1 for committee fault tolerance")
            if m_live < self.degree + 1:
                raise ValueError(
                    f"only {m_live} committee members alive but Shamir "
                    f"degree {self.degree} needs {self.degree + 1} shares")
        tamper = dict(committee_tamper or {})
        bad_targets = set(tamper) - set(com) | (set(tamper) & dropped)
        if bad_targets:
            raise ValueError(
                f"committee_tamper targets {sorted(bad_targets)} that "
                f"are not live members of committee {com}")

        # a poisoning dealer scales its update before encoding: its
        # shares and commitments are honest ones of the poisoned value
        flats = self._poison_flats(flats, ids, round_index)
        flats, wire_s = self._compress(flats, ids)
        # 1) every live party uploads one (sparsified) share to each live
        #    member: the only leg top-k shrinks
        self.net.send_batch(l * m_live, wire_s, "phase2_upload")
        if self.vss:
            # 1b) ... and its Feldman commitments, (degree+1) x 2 limbs
            #     per element (costmodel.phase2_commit_*)
            self.net.send_batch(l * m_live, (self.degree + 1) * 2 * s,
                                "phase2_commit")
        # 2) members chain-exchange partial sums (m−1, Eq. 5 middle term),
        #    on the union support of the sparse uploads: dense size s
        self.net.send_batch(m_live - 1, s, "phase2_exchange")
        if self.norm_bound is not None:
            # 2b) each non-final live member forwards its per-dealer
            #     rows to the final member, one message of l·s elements
            #     (costmodel.phase2_audit_*)
            self.net.send_batch(m_live - 1, l * s, "phase2_audit")
        # 3) the committee broadcasts the aggregate to every party
        self.net.send_batch(self.n, s, "phase2_broadcast")

        if not self.vss:
            self._finish_outcome(ids, dropped, set())
            if m_live == self.m:
                return self._secure_mean(self.agg, flats, ids, round_index)
            points = tuple(w + 1 for w in live_pos)
            return self._secure_mean(self.agg, flats, ids, round_index,
                                     member_rows=live_pos, points=points)
        return self._vss_aggregate(flats, ids, round_index, live_pos,
                                   dropped, tamper)

    def _poison_flats(self, flats, ids, round_index):
        """The dealer adversary's ``scale``/``sign_flip``: one float32
        multiply of each poisoned row (on a copy of ``flats``)."""
        active = {p: mode for p, (mode, rnd) in self.dealer_tamper.items()
                  if rnd == round_index and p in ids
                  and mode in ("scale", "sign_flip")}
        if not active:
            return flats
        flats = flats.clone()
        row = {p: k for k, p in enumerate(ids)}
        for p, mode in sorted(active.items()):
            factor = POISON_SCALE if mode == "scale" else -POISON_SCALE
            flats[row[p]] = flats[row[p]] * factor
        return flats

    # -- malicious-secure epilogue (verify -> blame -> reconstruct) -------

    def _member_sums(self, flats, ids, round_index, d):
        """Member sums ``[m, d]``, element-chunked on the §8 boundaries."""
        chunk = self.chunk_elems if self.chunk_elems is not None else d
        sums = [self.agg.sum_shares_batch(
                    flats[:, e_lo:min(e_lo + chunk, d)], seed=self.seed,
                    party_ids=ids, round_index=round_index,
                    chunk=self.chunk, elem_base=e_lo)
                for e_lo in range(0, d, chunk)]
        return torch.cat(sums, dim=-1) if len(sums) > 1 else sums[0]

    def _commit_words(self, elements):
        """Group elements ``[...]`` -> commitment words ``[..., 2]`` in
        the carrier of the transport's device."""
        words = vss.pack(elements)
        return (to_i32(words).contiguous() if self.device.type == "cuda"
                else words)

    def _dealer_commits(self, flats, keys, counter_base: int = 0):
        """Each dealer's commitments as group elements ``[l, e,
        degree+1]``: its coefficient streams re-derived from its key,
        as the shares draw them."""
        return vss.commit_elements(self.agg.encode(flats), keys[:, 0],
                                   keys[:, 1], self.degree,
                                   counter_base=counter_base)

    def _aggregate_commits(self, flats, ids, round_index, e_lo, e_hi):
        """Aggregate commitments ``[e_hi - e_lo, degree+1, 2]`` of
        elements ``[e_lo, e_hi)``: the product over every dealer of its
        commitments, built party chunk by party chunk as a running
        product — what each member computes from the dealers'
        messages."""
        keys = self.agg.party_key_words(self.seed, ids, round_index)
        acc = None
        for lo in range(0, len(ids), self.chunk):
            hi = min(lo + self.chunk, len(ids))
            part = vss.product(self._dealer_commits(
                flats[lo:hi, e_lo:e_hi], keys[lo:hi], e_lo // 4))
            acc = part if acc is None else vss.qmul(acc, part)
        return self._commit_words(acc)

    def _tampered_rows(self, member_sums, flats, ids, round_index, d,
                       tamper):
        """Apply the injected member corruptions to their sum rows."""
        com = self.committee
        rows = member_sums.clone() if tamper else member_sums
        for member, mode in tamper.items():
            w = com.index(int(member))
            if mode == "flip":
                bad = rows[w] ^ TAMPER_FLIP_MASK
            elif mode == "wrong_poly":
                k0, k1 = philox.derive_key(
                    self.seed ^ TAMPER_SEED_XOR,
                    (round_index << 24) | int(member))
                bad = words_like(to_field(philox.random_bits(
                    d, k0, k1, device=self.device)), rows)
            elif mode == "replay":
                if round_index == 0:
                    raise ValueError(
                        "replay tamper needs a previous round (the "
                        "member replays its round r-1 partial sum)")
                bad = self._member_sums(flats, ids, round_index - 1, d)[w]
            else:
                raise ValueError(
                    f"unknown tamper mode {mode!r}; expected "
                    "flip | wrong_poly | replay")
            rows[w] = bad
        return rows

    def _finish_outcome(self, ids, dropped, blamed,
                        blamed_dealers=frozenset()):
        """Fold the round's fault and blame sets through
        ``resolve_outcome`` and update the eviction and reputation state
        the next election reads."""
        members = set(ids)
        com_in = [w for w in self.committee if w in members]
        self.last_outcome = resolve_outcome(
            members, set(dropped) & members, set(),
            committee=com_in,
            reconstruct_threshold=(
                self.degree + 1 if self.scheme == "shamir" else self.m)
            if set(self.committee) <= members else None,
            resurrect=False, blamed=blamed,
            blamed_dealers=blamed_dealers)
        for p in set(blamed) | set(blamed_dealers):
            self.evicted.add(int(p))
            self.reputation[int(p)] = 0.0
        if self.reelect_each_round:
            # reputation steers only the per-round re-election, so a
            # single election keeps the exact integer scoring
            for w in set(dropped):
                self.reputation[int(w)] = \
                    self.reputation.get(int(w), 1.0) * 0.5

    def _verified_mean(self, live_rows, row_ok, live_pos, n_mean: int,
                       ids, dropped, blamed_dealers=frozenset()):
        """Blame the members whose rows failed, reconstruct the mean of
        ``n_mean`` updates from the rows that verified."""
        com = self.committee
        blamed = {com[live_pos[i]] for i in range(len(live_pos))
                  if not row_ok[i]}
        good = [i for i in range(len(live_pos)) if row_ok[i]]
        if len(good) < self.degree + 1:
            raise ValueError(
                f"only {len(good)} committee rows verified but Shamir "
                f"degree {self.degree} needs {self.degree + 1}; blamed "
                f"members: {sorted(blamed)}")
        self._finish_outcome(ids, dropped, blamed,
                             blamed_dealers=blamed_dealers)
        points = (None if len(good) == self.m
                  else tuple(live_pos[i] + 1 for i in good))
        return self.agg.reconstruct_mean(live_rows[good], n_mean,
                                         points=points)

    def _vss_aggregate(self, flats, ids, round_index, live_pos, dropped,
                       tamper):
        """Verify member rows chunk by chunk, blame, reconstruct."""
        malformed = sorted(
            p for p, (mode, rnd) in self.dealer_tamper.items()
            if mode == "malformed" and rnd == round_index and p in ids)
        if self.norm_bound is not None or malformed:
            return self._audited_vss_aggregate(
                flats, ids, round_index, live_pos, dropped, tamper,
                malformed)
        l, d = int(flats.shape[0]), int(flats.shape[1])
        with record_function("vss_member_sums"):
            member_sums = self._member_sums(flats, ids, round_index, d)
            rows = self._tampered_rows(member_sums, flats, ids,
                                       round_index, d, tamper)
            live_rows = rows[live_pos]
        points = tuple(w + 1 for w in live_pos)
        # verification rides the §8 element chunks: each chunk's
        # commitments draw the counters the chunk's shares drew
        chunk = self.chunk_elems if self.chunk_elems is not None else d
        row_ok = torch.ones(len(live_pos), dtype=torch.bool,
                            device=self.device)
        for e_lo in range(0, d, chunk):
            e_hi = min(e_lo + chunk, d)
            with record_function("vss_commit"):
                agg_commits = self._aggregate_commits(flats, ids,
                                                      round_index, e_lo,
                                                      e_hi)
            with record_function("vss_verify"):
                ok = verify_shares(live_rows[:, e_lo:e_hi].contiguous(),
                                   agg_commits, points)
                row_ok &= ok.bool().all(dim=1)
        return self._verified_mean(live_rows, row_ok.tolist(), live_pos,
                                   l, ids, dropped)

    def _audited_vss_aggregate(self, flats, ids, round_index, live_pos,
                               dropped, tamper, malformed):
        """The per-dealer epilogue of the norm audit (DESIGN.md §11).

        1. Every dealer's live share rows are verified against its own
           commitments; a mismatch is fatal (``ValueError``).
        2. Each dealer's decoded update is reconstructed from the live
           rows and its L2 norm held to ``norm_bound``; violators are
           blamed (``blamed_dealers``) and left out of the member sums.
        3. The member rows of the honest dealers' sums are verified
           against their aggregate commitments, and the mean is
           reconstructed over the honest count.

        The member sums are order-independent modular adds, so an
        all-honest audited round equals the un-audited one bit for bit.
        """
        l, d = int(flats.shape[0]), int(flats.shape[1])
        k_live = len(live_pos)
        points_live = tuple(w + 1 for w in live_pos)
        with record_function("vss_member_sums"):
            # whole-vector per-dealer stacks [l, m, d]
            stacks = self.agg.make_shares_batch(
                flats, seed=self.seed, party_ids=ids,
                round_index=round_index)
            row = {p: k for k, p in enumerate(ids)}
            for p in malformed:
                # a malformed dealer corrupts its share stream while
                # sending honest commitments
                stacks[row[p]] ^= TAMPER_FLIP_MASK
        with record_function("vss_commit"):
            keys = self.agg.party_key_words(self.seed, ids, round_index)
            commits = self._dealer_commits(flats, keys)    # [l, d, c]

        # 1) per-dealer verification: the dealers' rows side by side on
        #    the element axis, one kernel launch
        sel = stacks[:, live_pos, :]                           # [l, k, d]
        with record_function("vss_verify"):
            ok = verify_shares(
                sel.transpose(0, 1).reshape(k_live, l * d).contiguous(),
                self._commit_words(commits).reshape(l * d,
                                                    self.degree + 1, 2),
                points_live)
            dealer_ok = ok.reshape(k_live, l, d).bool().all(dim=2) \
                .all(dim=0).tolist()
        bad = sorted(ids[k] for k in range(l) if not dealer_ok[k])
        if bad:
            raise ValueError(
                f"dealer share verification failed for parties {bad} — "
                "shares do not match the dealer's own commitments")

        # 2) norm-bound audit of the decoded per-dealer updates
        blamed_dealers: set[int] = set()
        if self.norm_bound is not None:
            pts = None if k_live == self.m else points_live
            codes = self.agg.reconstruct_sum(sel.transpose(0, 1),
                                             points=pts)       # [l, d]
            decoded = self.agg.fp.decode_mean(codes, 1).cpu().numpy()
            blamed_dealers = {ids[k] for k in range(l)
                              if update_norm(decoded[k]) > self.norm_bound}
        honest = [k for k in range(l) if ids[k] not in blamed_dealers]
        if not honest:
            raise ValueError(
                f"the norm audit blamed every dealer {sorted(ids)} — "
                "no honest update left to aggregate")

        # 3) member-row verification of the honest dealers' sums
        with record_function("vss_member_sums"):
            member_sums = self.agg.reduce_party_shares(stacks[honest])
            rows = self._tampered_rows(member_sums, flats, ids,
                                       round_index, d, tamper)
            live_rows = rows[live_pos]
        with record_function("vss_commit"):
            agg_commits = self._commit_words(vss.product(commits[honest]))
        with record_function("vss_verify"):
            row_ok = verify_shares(live_rows, agg_commits, points_live) \
                .bool().all(dim=1).tolist()
        return self._verified_mean(live_rows, row_ok, live_pos,
                                   len(honest), ids, dropped,
                                   blamed_dealers=blamed_dealers)


SIM_TRANSPORTS = {
    "plain": PlainTransport,
    "p2p": P2PTransport,
    "two_phase": TwoPhaseTransport,
}


class SPMDTransport(Transport):
    """Adapter: the same protocol steps as collectives over a process
    group (``fl.spmd``, the scale path).

    Every party runs this object in its own process; ``aggregate`` takes
    the local party's flat update and returns the mean on every party.

      ================= ================== ===============================
      protocol          ``fl.spmd`` mode   what crosses between parties
      ================= ================== ===============================
      two_phase         ``psum``           the m-share stack, all-reduced
      two_phase_scatter ``reduce_scatter`` shares reduce-scattered, means
                                           all-gathered
      p2p               ``p2p``            n shares per party (m = n)
      plain             ``plain``          raw float all-reduce (no MPC)
      ================= ================== ===============================

    ``group`` replaces the reference's ``party_axes``; updates are moved
    to ``device`` (the card unless ``device="cpu"``).
    """

    MODE_FOR_PROTOCOL = {
        "two_phase": "psum",
        "two_phase_scatter": "reduce_scatter",
        "p2p": "p2p",
        "plain": "plain",
    }

    def __init__(self, protocol: str = "two_phase", *, n: int | None = None,
                 m: int = 3, scheme: str = "additive", seed: int = 0,
                 b: int = 10, group=None, mode: str | None = None,
                 fp: FixedPointConfig | None = None, block_rows: int = 64,
                 device="cuda"):
        if mode is None:
            if protocol not in self.MODE_FOR_PROTOCOL:
                raise ValueError(
                    f"unknown protocol {protocol!r}; expected one of "
                    f"{sorted(self.MODE_FOR_PROTOCOL)}")
            mode = self.MODE_FOR_PROTOCOL[protocol]
        self.device = dispatch.resolve_device(device)
        self.protocol = protocol
        self.mode = mode
        self.n = n
        self.m = m
        self.b = b
        self.scheme = scheme
        self.seed = seed
        self.group = group
        self.fp = fp
        self.block_rows = block_rows

    def _kw(self, round_index):
        return dict(scheme=self.scheme, m=self.m, group=self.group,
                    seed=self.seed, round_index=round_index, mode=self.mode,
                    block_rows=self.block_rows, fp=self.fp)

    def elect(self, round_index: int = 0):
        """Alg. 2 as one small sum over the parties."""
        from . import spmd
        if self.n is None:
            raise ValueError("SPMDTransport needs n= to run the election")
        return spmd.elect_committee_spmd(self.n, self.m, self.b,
                                         self.seed + round_index,
                                         group=self.group,
                                         device=self.device)

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0):
        """Per party: ``flats`` is THIS party's flat ``[D]`` update."""
        from . import spmd
        return spmd.secure_aggregate(torch.as_tensor(flats).to(self.device),
                                     **self._kw(round_index))

    def aggregate_tree(self, tree, *, round_index: int = 0,
                       chunk_elems: int | None = None):
        from . import spmd
        return spmd.secure_aggregate_tree(tree, chunk_elems=chunk_elems,
                                          **self._kw(round_index))


def make_transport(protocol: str, n: int, *, backend: str = "sim",
                   device="cuda", **kw) -> Transport:
    """Factory of the counting simulation transports on ``device``, of
    the SPMD adapter (``backend="spmd"``), or of the real wire
    (``backend="wire"``: a coordinator and one party worker process per
    party, the workers' math on ``device``; two_phase only)."""
    if backend == "spmd":
        return SPMDTransport(protocol, n=n, device=device, **kw)
    if backend == "wire":
        if protocol != "two_phase":
            raise ValueError(
                f"the wire backend only deploys the two_phase protocol, "
                f"not {protocol!r}")
        from repro_torch.net import WireTransport
        return WireTransport(n, device=device, **kw)
    if backend != "sim":
        raise ValueError(f"unknown backend {backend!r}")
    if protocol not in SIM_TRANSPORTS:
        raise ValueError(
            f"unknown protocol {protocol!r}; expected one of "
            f"{sorted(SIM_TRANSPORTS)}")
    return SIM_TRANSPORTS[protocol](n, device=device, **kw)
