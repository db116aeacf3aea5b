"""Communication cost model — paper Eqs. (1)–(8), as published.

A copy of the closed forms in ``repro/core/costmodel.py`` (the port
imports nothing of the reference).  ``Msg_Num`` counts point-to-point
messages; ``Msg_Size`` is in model elements (``s``) or vote elements
(``b``).  The counting transports of ``fl.transport`` must equal these
exactly; the wire's coordinator must equal the per-link byte forms at
the end.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Symbols of Table I."""
    n: int          # number of parties
    e: int = 15     # global FL epochs (aggregation rounds)
    s: int = 242    # model size in elements (SimpleNN default)
    m: int = 3      # committee size
    b: int = 10     # election vote batch size


# -- Peer-to-peer MPC (Eqs. 1-2) --------------------------------------------

def p2p_msg_num(p: CostParams) -> int:
    return (p.n * (p.n - 1)) * 2 * p.e


def p2p_msg_size(p: CostParams) -> int:
    return p2p_msg_num(p) * p.s


# -- Two-phase: Phase I election (Eqs. 3-4) ---------------------------------

def phase1_msg_num(p: CostParams) -> int:
    return (p.n * (p.n - 1)) * 2


def phase1_msg_size(p: CostParams) -> int:
    return phase1_msg_num(p) * p.b


# -- Two-phase: Phase II aggregation (Eqs. 5-6) ------------------------------

def phase2_msg_num(p: CostParams) -> int:
    # n uploads of m shares, m-1 committee chain exchanges, n broadcasts
    return (p.n * p.m + (p.m - 1) + p.n) * p.e


def phase2_msg_size(p: CostParams) -> int:
    return phase2_msg_num(p) * p.s


# -- Two-phase totals (Eqs. 7-8) ---------------------------------------------

def twophase_msg_num(p: CostParams) -> int:
    return phase1_msg_num(p) + phase2_msg_num(p)


def twophase_msg_size(p: CostParams) -> int:
    return phase1_msg_size(p) + phase2_msg_size(p)


def expand_eq7(p: CostParams) -> int:
    """Eq. (7) in its published expanded form (cross-check of algebra)."""
    n, m, e = p.n, p.m, p.e
    return 2 * n * n + n * (m * e + e - 2) + m * e - e


def expand_eq8(p: CostParams) -> int:
    """Eq. (8) in its published expanded form."""
    n, m, e, s, b = p.n, p.m, p.e, p.s, p.b
    return (2 * n * n * b + n * (m * e * s + e * s - 2 * b)
            + m * e * s - e * s)


def reduction_factor(p: CostParams) -> float:
    """Headline scalability ratio: P2P elements / two-phase elements."""
    return p2p_msg_size(p) / twophase_msg_size(p)


def summary(p: CostParams) -> dict:
    return {
        "n": p.n, "m": p.m, "e": p.e, "s": p.s, "b": p.b,
        "p2p_msg_num": p2p_msg_num(p),
        "p2p_msg_size": p2p_msg_size(p),
        "phase1_msg_num": phase1_msg_num(p),
        "phase1_msg_size": phase1_msg_size(p),
        "phase2_msg_num": phase2_msg_num(p),
        "phase2_msg_size": phase2_msg_size(p),
        "twophase_msg_num": twophase_msg_num(p),
        "twophase_msg_size": twophase_msg_size(p),
        "reduction_factor": reduction_factor(p),
    }


# -- Top-k-sparsified variants of Eqs. 2/4/6 ---------------------------------
#
# A top-k upload is k values + k public index words = 2k elements
# (``compression.compressed_size``).  Legs that carry *sums* of
# differently-supported sparse updates (P2P partial sums, the committee
# chain exchange, the broadcast) live on the union support and are
# counted at the dense size ``s``, so the closed forms equal what the
# counting transports measure.  Phase I (votes of size b) and the
# message counts (Eqs. 1/3/5) are unchanged.

def sparsified_s(p: CostParams, ratio: float) -> int:
    """Elements per sparsified upload: k values + k index words."""
    return 2 * max(1, int(p.s * ratio))


def p2p_msg_size_topk(p: CostParams, ratio: float) -> int:
    """Eq. 2 with top-k uploads: share leg at 2k, partial sums dense."""
    return p.n * (p.n - 1) * p.e * (sparsified_s(p, ratio) + p.s)


def phase1_msg_size_topk(p: CostParams, ratio: float) -> int:
    """Eq. 4 under top-k, unchanged: election votes are b-vectors."""
    return phase1_msg_size(p)


def phase2_msg_size_topk(p: CostParams, ratio: float) -> int:
    """Eq. 6 with top-k uploads (n·m at 2k; exchange and broadcast
    dense)."""
    return (p.n * p.m * sparsified_s(p, ratio)
            + ((p.m - 1) + p.n) * p.s) * p.e


def twophase_msg_size_topk(p: CostParams, ratio: float) -> int:
    """Eq. 8 with top-k uploads (Eq. 4 + sparsified Eq. 6)."""
    return phase1_msg_size_topk(p, ratio) + phase2_msg_size_topk(p, ratio)


def combined_reduction_factor(p: CostParams, ratio: float) -> float:
    """Compression × two-phase: dense-P2P elements / sparsified
    two-phase."""
    return p2p_msg_size(p) / twophase_msg_size_topk(p, ratio)


def summary_topk(p: CostParams, ratio: float) -> dict:
    return {
        "n": p.n, "m": p.m, "e": p.e, "s": p.s, "b": p.b,
        "top_k_ratio": ratio,
        "sparsified_s": sparsified_s(p, ratio),
        "p2p_msg_size_topk": p2p_msg_size_topk(p, ratio),
        "phase2_msg_size_topk": phase2_msg_size_topk(p, ratio),
        "twophase_msg_size_topk": twophase_msg_size_topk(p, ratio),
        "combined_reduction_factor": combined_reduction_factor(p, ratio),
    }

# -- Feldman-VSS commitment broadcast (Eq. 5-6 extensions) -------------------
#
# With verifiable secret sharing each party sends its Feldman commitments
# to each committee member beside its share upload: one message per
# (party, member) of ``(degree+1) * 2 * s`` words (two 32-bit limbs per
# element of F_q).  Verification is local, so the commitment legs are the
# whole extension; the transport counts them under ``phase2_commit``.


def _vss_degree(p: CostParams, degree: int | None) -> int:
    return (p.m - 1) if degree is None else int(degree)


def vss_commit_elems(p: CostParams, degree: int | None = None) -> int:
    """Elements per commitment message: (d+1) coefficients x 2 limbs."""
    return (_vss_degree(p, degree) + 1) * 2 * p.s


def phase2_commit_msg_num(p: CostParams) -> int:
    """One commitment message per (party, member) per epoch."""
    return p.n * p.m * p.e


def phase2_commit_msg_size(p: CostParams, degree: int | None = None) -> int:
    return phase2_commit_msg_num(p) * vss_commit_elems(p, degree)


def twophase_msg_num_vss(p: CostParams) -> int:
    """Eq. 7 extended with the commitment legs."""
    return twophase_msg_num(p) + phase2_commit_msg_num(p)


def twophase_msg_size_vss(p: CostParams, degree: int | None = None) -> int:
    """Eq. 8 extended with the commitment legs."""
    return twophase_msg_size(p) + phase2_commit_msg_size(p, degree)


def vss_overhead_factor(p: CostParams, degree: int | None = None) -> float:
    """VSS-extended elements / plain two-phase elements."""
    return twophase_msg_size_vss(p, degree) / twophase_msg_size(p)


# -- Norm-bound dealer audit ---------------------------------------------------
#
# With ``norm_bound`` each non-final live member forwards its per-dealer
# share rows to the final member, which reconstructs every dealer's
# update and blames those above the bound: one message per (non-final
# member, epoch) of ``n * s`` elements, counted under ``phase2_audit``.


def phase2_audit_elems(p: CostParams) -> int:
    """Elements per audit message: n dealer rows of s elements."""
    return p.n * p.s


def phase2_audit_msg_num(p: CostParams) -> int:
    """One audit message per non-final live member per epoch."""
    return (p.m - 1) * p.e


def phase2_audit_msg_size(p: CostParams) -> int:
    return phase2_audit_msg_num(p) * phase2_audit_elems(p)


# -- Per-round committee re-election (Eqs. 3-4 every epoch) -------------------
#
# Alg. 2 run every round multiplies the election legs by e (for the
# common single-subround election; the transport counts the subrounds
# it actually ran).


def phase1_msg_num_reelect(p: CostParams) -> int:
    return p.e * phase1_msg_num(p)


def phase1_msg_size_reelect(p: CostParams) -> int:
    return p.e * phase1_msg_size(p)


def summary_vss(p: CostParams, degree: int | None = None) -> dict:
    return {
        "n": p.n, "m": p.m, "e": p.e, "s": p.s, "b": p.b,
        "degree": _vss_degree(p, degree),
        "vss_commit_elems": vss_commit_elems(p, degree),
        "phase2_commit_msg_num": phase2_commit_msg_num(p),
        "phase2_commit_msg_size": phase2_commit_msg_size(p, degree),
        "twophase_msg_num_vss": twophase_msg_num_vss(p),
        "twophase_msg_size_vss": twophase_msg_size_vss(p, degree),
        "vss_overhead_factor": vss_overhead_factor(p, degree),
        "phase1_msg_num_reelect": phase1_msg_num_reelect(p),
        "phase1_msg_size_reelect": phase1_msg_size_reelect(p),
    }


# -- Cohort-sampled rounds (Eqs. 3-6 per cohort) -----------------------------
#
# With a registry of ``n`` parties and a sampled per-round cohort of
# ``c`` (DESIGN.md §12) the election and the upload legs run over the
# cohort while the aggregate broadcast still reaches the whole registry.
# Cohort mode implies per-round election (one subround assumed here; the
# counting transports count the subrounds they ran).  Legs, per epoch:
#
# * Phase I   — ``2·c·(c−1)`` messages of ``b``   (Eqs. 3-4 at n=c)
# * uploads   — ``c·m``       messages of ``s``
# * exchange  — ``m−1``       messages of ``s``
# * broadcast — ``n``         messages of ``s``   (whole registry)


def phase1_cohort_msg_num(p: CostParams, c: int) -> int:
    return p.e * 2 * c * (c - 1)


def phase1_cohort_msg_size(p: CostParams, c: int) -> int:
    return phase1_cohort_msg_num(p, c) * p.b


def phase2_cohort_msg_num(p: CostParams, c: int) -> int:
    return (c * p.m + (p.m - 1) + p.n) * p.e


def phase2_cohort_msg_size(p: CostParams, c: int) -> int:
    return phase2_cohort_msg_num(p, c) * p.s


def twophase_cohort_msg_num(p: CostParams, c: int) -> int:
    return phase1_cohort_msg_num(p, c) + phase2_cohort_msg_num(p, c)


def twophase_cohort_msg_size(p: CostParams, c: int) -> int:
    return phase1_cohort_msg_size(p, c) + phase2_cohort_msg_size(p, c)


def cohort_reduction_factor(p: CostParams, c: int) -> float:
    """Whole-registry two-phase elements with per-round election / cohort
    elements."""
    full = (p.e * phase1_msg_size(p)) + phase2_msg_size(p)
    return full / twophase_cohort_msg_size(p, c)


def summary_cohort(p: CostParams, c: int) -> dict:
    return {
        "n": p.n, "m": p.m, "e": p.e, "s": p.s, "b": p.b, "c": c,
        "phase1_cohort_msg_num": phase1_cohort_msg_num(p, c),
        "phase1_cohort_msg_size": phase1_cohort_msg_size(p, c),
        "phase2_cohort_msg_num": phase2_cohort_msg_num(p, c),
        "phase2_cohort_msg_size": phase2_cohort_msg_size(p, c),
        "twophase_cohort_msg_num": twophase_cohort_msg_num(p, c),
        "twophase_cohort_msg_size": twophase_cohort_msg_size(p, c),
        "cohort_reduction_factor": cohort_reduction_factor(p, c),
    }


# -- Per-link coordinator byte forms (wire topologies; DESIGN.md §13) --------
#
# Eqs. 1-8 count *logical* messages and are topology-independent: the
# committee-sharded relay tree moves traffic between links without
# changing a single counter.  What the topology *does* change is which
# frames cross the coordinator's own sockets.  These forms price that,
# in real bytes, for one honest round with every party live and
# included (and, under the tree, every member's region non-empty —
# ``fl.cohort.assign_home`` decides that; the bench asserts it).  A
# frame is ``FRAME_OVERHEAD_BYTES`` of envelope (4-byte length prefix +
# 32-byte v2 header) plus 4 bytes per element (uint32 shares and
# float32 means alike), and a logical message of ``E`` elements ships
# in ``ceil(E / chunk_elems)`` frames.  Only frames carrying a counted
# data phase (``Phase.COUNTER_NAMES``) are priced — JSON control
# chatter is serialization-dependent and deliberately outside — which
# is exactly what ``Coordinator.data_bytes_in/out`` measure, so the
# cross-check is equality, not approximation.
#
# Per-round data legs crossing the coordinator (c uploaders, committee
# m, model s, votes b, ``subrounds`` election subrounds):
#
#   ingress, hub : votes 2·c·(c−1)·subrounds × b │ uploads c·m × s
#                  │ exchange (m−1) × s │ result 1 × s
#   ingress, tree: votes (same) │ region sums m·(m−1) × s
#                  │ exchange (m−1) × s │ result 1 × s
#   egress,  hub : votes (same) │ input c × s │ uploads c·m × s
#                  │ exchange (m−1) × s │ broadcast n × s
#   egress,  tree: votes (same) │ input c × s │ region sums m·(m−1) × s
#                  │ exchange (m−1) × s │ broadcast n × s
#
# Under VSS the hub adds commitment relays (c·m × (deg+1)·2·s, in and
# out) and the tree adds regional commitments: every home member with a
# non-empty region broadcasts its regional aggregate commitments to
# every *other* live member — m·(m−1) × (deg+1)·2·s, in and out — so
# each receiver can bind the incoming REGION_SUMs to the sender's
# dealers before folding them (the commitment-bound verification rule,
# DESIGN.md §13).  The headline: tree coordinator ingress for Phase II
# drops from O(c·m·s) to O(m²·s) — *independent of c* (the uploads
# never touch the hub), at the price of O(m·s) extra bandwidth at each
# home member.
#
# With the norm-bound audit on (``audit=True``; needs ``region_sizes``
# — the per-member region cardinalities, final member last, because
# the escrow legs are region-size-dependent):
#
# * REGION_COMMIT carries the *per-dealer concatenation* instead of
#   the aggregate — (m−1) messages of |region_h|·(deg+1)·2·s per
#   sender h (receivers still fold the aggregate locally; the final
#   member needs dealer granularity to re-aggregate over honest
#   dealers post-blame);
# * each non-final home member h with a non-empty region escrows its
#   per-dealer share rows to the final member — one DEALER_ROWS
#   message of |region_h|·m·s elements (all m member evaluation
#   points; phase2_audit phase), in and out.
#
# The hub audit leg ((m−1) messages of c·s — phase2_audit_*) also
# crosses the coordinator and is priced under ``audit=True`` there.

FRAME_OVERHEAD_BYTES = 36    # 4-byte length prefix + 32-byte header
ELEM_BYTES = 4               # uint32 and float32 elements alike


def message_frames(elems: int, chunk_elems: int) -> int:
    """Frames one logical message of ``elems`` elements ships in."""
    if elems < 1:
        raise ValueError(f"elems={elems}: zero-element messages are "
                         "protocol violations on the wire")
    return -(-elems // chunk_elems)


def message_wire_bytes(elems: int, chunk_elems: int) -> int:
    """Exact bytes of one chunked logical message on the wire."""
    return (elems * ELEM_BYTES
            + message_frames(elems, chunk_elems) * FRAME_OVERHEAD_BYTES)


def coordinator_round_legs(p: CostParams, *, c: int | None = None,
                           relay: str = "hub", subrounds: int = 1,
                           vss: bool = False,
                           degree: int | None = None,
                           audit: bool = False,
                           region_sizes=None) -> dict:
    """``{"in": [(msg_num, elems), ...], "out": [...]}`` — the data
    legs crossing the coordinator in one honest round (see the block
    comment for the leg inventory and its preconditions)."""
    if relay not in ("hub", "tree"):
        raise ValueError(f"relay={relay!r} must be 'hub' or 'tree'")
    if audit and not vss:
        raise ValueError("audit=True needs vss=True (unverified rows "
                         "cannot carry a blame decision)")
    c = p.n if c is None else int(c)
    votes = (subrounds * 2 * c * (c - 1), p.b)
    if relay == "hub":
        fan_in = [(c * p.m, p.s)]
        if vss:
            fan_in.append((c * p.m, vss_commit_elems(p, degree)))
        if audit:
            fan_in.append((p.m - 1, c * p.s))       # DEALER_ROWS
    else:
        if region_sizes is None:
            if audit:
                raise ValueError(
                    "audit=True under relay='tree' needs region_sizes "
                    "(the escrow legs are region-size-dependent)")
            # bench precondition: every member's region non-empty
            fan_in = [(p.m * (p.m - 1), p.s)]
            if vss:
                fan_in.append((p.m * (p.m - 1),
                               vss_commit_elems(p, degree)))
        else:
            sizes = [int(x) for x in region_sizes]
            if len(sizes) != p.m or sum(sizes) != c:
                raise ValueError(
                    f"region_sizes={sizes} must have one entry per "
                    f"member (m={p.m}, final member last) summing to "
                    f"the uploader count c={c}")
            fan_in = []
            for k, size in enumerate(sizes):
                if size < 1:
                    continue
                fan_in.append((p.m - 1, p.s))        # REGION_SUM
                if vss:
                    per_msg = (size * vss_commit_elems(p, degree)
                               if audit
                               else vss_commit_elems(p, degree))
                    fan_in.append((p.m - 1, per_msg))  # REGION_COMMIT
                if audit and k != p.m - 1:
                    # escrowed per-dealer rows, all m member points
                    fan_in.append((1, size * p.m * p.s))
    exchange = (p.m - 1, p.s)
    legs_in = [votes, *fan_in, exchange, (1, p.s)]          # + RESULT
    legs_out = [votes, (c, p.s), *fan_in, exchange,         # + INPUT
                (p.n, p.s)]                                 # + broadcast
    return {"in": legs_in, "out": legs_out}


def coordinator_data_bytes(p: CostParams, *, c: int | None = None,
                           relay: str = "hub", subrounds: int = 1,
                           chunk_elems: int, vss: bool = False,
                           degree: int | None = None,
                           audit: bool = False,
                           region_sizes=None) -> tuple[int, int]:
    """Exact ``(data_bytes_in, data_bytes_out)`` at the coordinator for
    one honest round — equal (not approximate) to what
    ``Coordinator.data_bytes_in/out`` measure under the same config."""
    legs = coordinator_round_legs(p, c=c, relay=relay,
                                  subrounds=subrounds, vss=vss,
                                  degree=degree, audit=audit,
                                  region_sizes=region_sizes)
    return tuple(
        sum(num * message_wire_bytes(elems, chunk_elems)
            for num, elems in legs[key])
        for key in ("in", "out"))
