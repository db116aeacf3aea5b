"""Federation config shared by coordinator and party workers.

Counterpart of ``repro/net/config.py``: the same fields in the same
order, so the WELCOME JSON of either package's coordinator loads in
either package's worker.  The device is not a field: each worker picks
its own (``--device``), and ``aggregator(device)`` builds the port's
``SecureAggregator`` there.

The coordinator owns the configuration; party workers receive it in
the WELCOME frame (JSON payload), so a worker needs nothing on its
command line beyond ``--host/--port/--party-id``.  Everything that
affects the share math (scheme, fixed-point codec, Shamir degree,
chunking) travels here — both sides must construct bit-identical
``SecureAggregator`` objects or the protocol's cross-checks fail.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.aggregation import (DEFAULT_CHUNK_ELEMS,
                                          SecureAggregator,
                                          _check_chunk_elems)
from repro_torch.core.fixed_point import (DEFAULT_FIELD, DEFAULT_RING,
                                          FixedPointConfig)

from .wire import MAX_PAYLOAD_BYTES, ProtocolError

__all__ = ["WireConfig"]


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Everything a party needs to run the protocol bit-identically."""

    n: int
    m: int = 3
    b: int = 10
    seed: int = 0
    scheme: str = "additive"
    shamir_degree: int | None = None
    frac_bits: int = 16
    clip: float = 64.0
    algebra: str = "ring"
    #: element-chunk size for streamed share/input/broadcast messages —
    #: same alignment contract as the streaming aggregation pipeline
    chunk_elems: int = DEFAULT_CHUNK_ELEMS
    #: per-stage straggler deadline (None disables; EOF dropout
    #: detection is always on)
    deadline_s: float | None = 30.0
    #: Feldman verifiable secret sharing (Shamir only): dealers
    #: broadcast commitments, members verify shares before summing,
    #: the final member verifies partial-sum rows and blames tampering
    #: members before reconstruction (DESIGN.md §10)
    vss: bool = False
    #: re-run Alg. 2 at the start of every aggregation round, evicting
    #: blamed members and down-weighting faulted ones
    reelect_each_round: bool = False
    #: L2 norm bound of the per-dealer audit (DESIGN.md §11): non-final
    #: members forward their per-dealer rows to the final member, which
    #: reconstructs each dealer's decoded update and blames the ones
    #: whose norm exceeds the bound.  Requires vss (the rows must be
    #: commitment-verified before they can carry blame).  Composes with
    #: ``relay="tree"``: home members escrow the per-dealer rows they
    #: fold and stream them to the final member during PHASE2_AUDIT
    #: (DESIGN.md §13).
    norm_bound: float | None = None
    #: per-round cohort size (DESIGN.md §12): ``n`` becomes the
    #: registry and each round elects over / uploads from a seeded
    #: sampled cohort (``fl.cohort.sample_cohort``); None keeps full
    #: participation
    cohort: int | None = None
    #: overlap Phase I of round r+1 with Phase II of round r (cohort
    #: mode only): the coordinator kicks off the next round's election
    #: while this round's uploads are still streaming (DESIGN.md §12)
    pipeline: bool = False
    #: registration-lease duration; a party whose lease lapses must
    #: re-register (None = leases never expire)
    lease_s: float | None = 30.0
    #: party->member traffic topology (DESIGN.md §13): ``"hub"`` relays
    #: every SHARE_UPLOAD/COMMITMENT frame through the coordinator
    #: socket; ``"tree"`` assigns each party a Philox-keyed home
    #: committee member (``fl.cohort.assign_home``), parties stream
    #: uploads straight to their home member's region listener, and
    #: members forward only regional partial sums — coordinator ingress
    #: drops from O(c·m·s) to O(m²·s), independent of the cohort size
    relay: str = "hub"
    #: pre-round compile warm-up barrier: before each round's stage
    #: monitors arm, the coordinator sends every live party a WARMUP
    #: frame carrying the round's exact shapes, parties JIT the
    #: round's kernels on dummy data and ack — so first-use JIT
    #: compilation (Feldman gpow ladders, per-point-set verify_shares
    #: recompiles) never burns the straggler deadline (the
    #: deadline_s=None footgun of the VSS wire tests)
    warmup: bool = False

    def __post_init__(self):
        _check_chunk_elems(self.chunk_elems)
        if self.chunk_elems * 4 > MAX_PAYLOAD_BYTES:
            raise ValueError(
                f"chunk_elems={self.chunk_elems} exceeds the "
                f"{MAX_PAYLOAD_BYTES}-byte frame payload bound")
        if self.vss and self.scheme != "shamir":
            raise ValueError(
                "vss=True needs scheme='shamir' (Feldman commitments "
                "verify polynomial evaluations)")
        if self.norm_bound is not None:
            if not self.vss:
                raise ValueError(
                    "norm_bound needs vss=True: unverified per-dealer "
                    "rows cannot carry a blame decision")
            if not self.norm_bound > 0:
                raise ValueError(
                    f"norm_bound={self.norm_bound} must be positive")
        if self.cohort is not None:
            if not 1 <= self.cohort <= self.n:
                raise ValueError(
                    f"cohort={self.cohort} must be in 1..n={self.n} "
                    "(the cohort samples from the registry)")
            if self.cohort < self.m:
                raise ValueError(
                    f"cohort={self.cohort} cannot seat a committee of "
                    f"m={self.m}")
        if self.pipeline and self.cohort is None:
            raise ValueError(
                "pipeline=True needs cohort mode: only per-round cohort "
                "elections can overlap the previous round's Phase II")
        if self.lease_s is not None and not self.lease_s > 0:
            raise ValueError(
                f"lease_s={self.lease_s} must be positive (or None)")
        if self.relay not in ("hub", "tree"):
            raise ValueError(
                f"relay={self.relay!r} must be 'hub' or 'tree'")

    def fp(self) -> FixedPointConfig:
        return FixedPointConfig(frac_bits=self.frac_bits, clip=self.clip,
                                algebra=self.algebra)

    def aggregator(self, device="cuda") -> SecureAggregator:
        """The party-side share math on ``device`` (the card unless the
        CPU is asked for)."""
        return SecureAggregator(scheme=self.scheme, m=self.m,
                                fp=self.fp(),
                                shamir_degree=self.shamir_degree,
                                device=device)

    def degree(self) -> int:
        """Shamir polynomial degree (the paper's m-1 default)."""
        return (self.shamir_degree if self.shamir_degree is not None
                else self.m - 1)

    def reconstruct_threshold(self) -> int:
        """Live committee members a round needs to reconstruct."""
        if self.scheme == "shamir":
            return self.degree() + 1
        return self.m

    def commit_elems(self, d: int) -> int:
        """uint32 elements of one dealer's commitment message
        (element-major ``[d, degree+1, 2]`` — ``vss.commit_elems``)."""
        return d * (self.degree() + 1) * 2

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "WireConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - fields
        if unknown:
            raise ProtocolError(
                f"WELCOME config carries unknown fields {sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def from_aggregation_kwargs(cls, n: int, *, m: int = 3, b: int = 10,
                                seed: int = 0, scheme: str = "additive",
                                fp: FixedPointConfig | None = None,
                                shamir_degree: int | None = None,
                                chunk_elems: int | None = None,
                                deadline_s: float | None = 30.0,
                                vss: bool = False,
                                reelect_each_round: bool = False,
                                norm_bound: float | None = None,
                                cohort: int | None = None,
                                pipeline: bool = False,
                                lease_s: float | None = 30.0,
                                relay: str = "hub",
                                warmup: bool = False
                                ) -> "WireConfig":
        """Build from the simulation transports' kwarg vocabulary."""
        if scheme not in ("additive", "shamir"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if fp is None:
            # the scheme's default codec, as the aggregator picks it,
            # so both sides agree on the algebra
            fp = DEFAULT_FIELD if scheme == "shamir" else DEFAULT_RING
        return cls(n=n, m=m, b=b, seed=seed, scheme=scheme,
                   shamir_degree=shamir_degree, frac_bits=fp.frac_bits,
                   clip=fp.clip, algebra=fp.algebra,
                   chunk_elems=(DEFAULT_CHUNK_ELEMS if chunk_elems is None
                                else chunk_elems),
                   deadline_s=deadline_s, vss=vss,
                   reelect_each_round=reelect_each_round,
                   norm_bound=norm_bound, cohort=cohort,
                   pipeline=pipeline, lease_s=lease_s, relay=relay,
                   warmup=warmup)
