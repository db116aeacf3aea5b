"""Federated data partitioning: Dirichlet non-IID splits and loaders.

A copy of ``repro/data/partition.py`` (numpy only; the port imports
nothing of the reference): the same seeds give the same index arrays.
"""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels, n_parties: int, alpha: float = 0.5,
                        seed: int = 0):
    """Classic FL non-IID split: per-class Dirichlet allocation.

    Returns a list of index arrays, one per party.
    """
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    parts = [[] for _ in range(n_parties)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        weights = rng.dirichlet([alpha] * n_parties)
        cuts = (np.cumsum(weights)[:-1] * len(idx)).astype(int)
        for p, chunk in enumerate(np.split(idx, cuts)):
            parts[p].append(chunk)
    return [np.concatenate(p) for p in parts]


class PartyLoader:
    """Minibatch iterator over one party's local shard."""

    def __init__(self, x, y, batch: int, seed: int = 0):
        self.x, self.y, self.batch = x, y, batch
        self.rng = np.random.RandomState(seed)

    def epoch(self):
        idx = self.rng.permutation(len(self.x))
        for s in range(0, len(idx) - self.batch + 1, self.batch):
            sel = idx[s:s + self.batch]
            yield self.x[sel], self.y[sel]
