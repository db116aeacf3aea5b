"""Communication cost model — paper Eqs. (1)–(8), as published.

A copy of the closed forms in ``repro/core/costmodel.py`` (the port
imports nothing of the reference).  ``Msg_Num`` counts point-to-point
messages; ``Msg_Size`` is in model elements (``s``) or vote elements
(``b``).  The counting transports of ``fl.transport`` must equal these
exactly.  The top-k and per-link coordinator forms come with the
slices that port those features (ROADMAP queue 1, items 6 and 8).
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
