"""Chunked first-order linear recurrence: ``h_t = a_t·h_{t-1} + b_t``.

Counterpart of ``repro/models/scan_utils.py``: a sequential carry across
chunks of ``chunk`` steps, an associative scan inside each chunk.  It is
the SSM block's plain path (on the CPU, under autograd, and for
``impl="dense"``); the fused kernel is ``kernels/ssm_scan``.

PyTorch has no associative scan, so ``associative_scan`` writes out the
recursion of ``jax.lax.associative_scan`` (``_scan`` in
``jax/_src/lax/control_flow/loops.py``): combine adjacent pairs, recurse
on the pairs, combine each odd prefix with the next even element, and
interleave.  The combines happen in the same order on the same operands,
so the float operations are the reference's.
"""

from __future__ import annotations

import torch


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """``even[0], odd[0], even[1], ...`` along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    out = pairs.reshape((even.shape[0], 2 * n) + tuple(odd.shape[2:]))
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def associative_scan(elems):
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under ``_combine``."""
    num = elems[0].shape[1]
    if num < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:-1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(reduced)
    if num % 2 == 0:
        even = _combine(tuple(o[:, :-1] for o in odd),
                        tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def chunked_linear_scan(a, b, h0=None, chunk: int = 64):
    """a, b: ``[B, S, ...]``; h0: ``[B, ...]`` initial state (zeros if
    None).

    Returns (h: ``[B, S, ...]`` all states, h_last: ``[B, ...]``).
    """
    bsz, s = a.shape[0], a.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"scan chunk {chunk} (the reference asserts the "
                         "same)")
    h = torch.zeros((bsz,) + tuple(a.shape[2:]), dtype=a.dtype,
                    device=a.device) if h0 is None else h0
    hs = []
    for c0 in range(0, s, chunk):
        a_ch, b_ch = a[:, c0:c0 + chunk], b[:, c0:c0 + chunk]
        # fold the carry into the first step: h_1 = a_1·h0 + b_1
        b_ch = torch.cat([(b_ch[:, 0] + a_ch[:, 0] * h)[:, None],
                          b_ch[:, 1:]], dim=1)
        _, hh = associative_scan((a_ch, b_ch))
        h = hh[:, -1]
        hs.append(hh)
    return torch.cat(hs, dim=1), h
