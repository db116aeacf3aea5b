"""Synthetic data as numpy: LM token batches and the paper's motor-fault
tabular task (§IV-A).

Copies of ``lm_batch``, ``fault_detection_party`` and
``train_test_split`` from ``repro/data/synthetic.py``.  The LM stream is
a per-party unigram tilt, reproducible from (seed, party, step).  The
fault task has 121 time-domain features, binary healthy/faulty labels,
a party-specific fault signature (non-IID) plus a shared one, so
federation helps.  The same seeds give the same arrays as the reference.
"""

from __future__ import annotations

import numpy as np


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int, party: int,
             step: int):
    """Deterministic non-IID token batch: (tokens, labels) int32 [B, S]."""
    rng = np.random.RandomState(
        (seed * 1_000_003 + party * 7919 + step) % (2 ** 31 - 1))
    # party-specific unigram tilt over a smallish support to keep losses
    # learnable at smoke scale
    support = min(vocab, 64)
    logits = rng.randn(support) * 1.5
    probs = np.exp(logits) / np.exp(logits).sum()
    toks = rng.choice(support, size=(batch, seq + 1), p=probs)
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))


def fault_detection_party(n_samples: int, *, seed: int, party: int,
                          n_features: int = 121):
    """One company's motor data: features [N, 121], labels [N] in {0,1}."""
    rng = np.random.RandomState(seed * 7907 + party)
    x = rng.randn(n_samples, n_features).astype(np.float32)
    y = (rng.rand(n_samples) < 0.45).astype(np.int32)
    sig_size = 24
    sig_idx = rng.choice(n_features, size=sig_size, replace=False)
    shift = rng.randn(sig_size).astype(np.float32)
    shift = 1.2 * shift / np.linalg.norm(shift) * np.sqrt(sig_size)
    x[np.ix_(y == 1, sig_idx)] += shift
    # shared (global) fault signature so federation helps
    g_idx = np.arange(0, n_features, 5)
    x[np.ix_(y == 1, g_idx)] += 0.8
    return x, y


def train_test_split(x, y, frac: float = 0.8, seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(x))
    cut = int(len(x) * frac)
    tr, te = idx[:cut], idx[cut:]
    return (x[tr], y[tr]), (x[te], y[te])
