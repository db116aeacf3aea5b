"""Communication cost model — paper Eqs. (1)–(8), as published.

A copy of the closed forms in ``repro/core/costmodel.py`` (the port
imports nothing of the reference).  ``Msg_Num`` counts point-to-point
messages; ``Msg_Size`` is in model elements (``s``) or vote elements
(``b``).  The counting transports of ``fl.transport`` must equal these
exactly.  The top-k, VSS, cohort and per-link forms come with the
slices that port those features.
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
