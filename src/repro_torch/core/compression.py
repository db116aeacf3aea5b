"""Top-k compression with error feedback, ahead of secret sharing.

Counterpart of ``repro/core/compression.py``.  A party sends the k
largest-magnitude coordinates of its update plus its carried residual
(Lin et al., Deep Gradient Compression) and keeps the unsent mass in its
error state for the next round.  The indices are public metadata; only
the values are secret-shared.  ``compressed_size`` is what one upload
costs on the wire: k values and k index words.

Where the reference's operations and PyTorch's part, the port follows
the reference's bits:

* **ties** — ``jax.lax.top_k`` keeps the lowest index among equal
  magnitudes and ``torch.topk`` does not promise it, so the selection is
  pinned to the lowest index: everything above the k-th magnitude plus
  the lowest-indexed entries equal to it (``topk_mask``, which both the
  single-row and the batch form use);
* **densify** adds the values onto zeros, as ``zeros.at[idx].add`` does,
  so a sent ``-0.0`` lands as ``+0.0``;
* **k** is ``max(1, int(d * ratio))`` in a Python float.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    top_k_ratio: float = 0.01     # fraction of coordinates kept
    error_feedback: bool = True

    def __post_init__(self):
        if not 0.0 < self.top_k_ratio <= 1.0:
            raise ValueError(
                f"top_k_ratio={self.top_k_ratio} must be in (0, 1]")


def top_k_count(d: int, ratio: float) -> int:
    """Coordinates kept of ``d``: ``max(1, int(d * ratio))``."""
    return max(1, int(d * ratio))


def init_error_state(flat):
    return torch.zeros_like(flat)


def topk_mask(mag, k: int):
    """Boolean mask of the top-k entries of each row of ``mag`` ``[..., D]``:
    every entry above the row's k-th largest value, then the
    lowest-indexed entries equal to it, k in all (the set of
    ``jax.lax.top_k``)."""
    kth = torch.topk(mag, k, dim=-1, sorted=False).values.amin(
        dim=-1, keepdim=True)
    above = mag > kth
    tied = mag == kth
    room = k - above.sum(dim=-1, keepdim=True)
    return above | (tied & (torch.cumsum(tied, dim=-1) <= room))


def compress_topk(flat, cfg: CompressionConfig, error_state):
    """Return ``(values [k], indices [k], new_error_state)``.

    ``flat + error_state`` (with error feedback) is sparsified: the k
    largest magnitudes, largest first, the lowest index first among
    equals (``jax.lax.top_k``'s order).  The sent coordinates are zeroed
    in the new error state; without error feedback the old state is
    kept.
    """
    carried = flat + error_state if cfg.error_feedback else flat
    mag = carried.abs()
    sent = topk_mask(mag, top_k_count(carried.shape[0], cfg.top_k_ratio))
    chosen = torch.nonzero(sent).squeeze(1)   # ascending index
    # largest first; the stable sort keeps ascending index among equals
    idx = chosen[torch.sort(mag[chosen], descending=True,
                            stable=True).indices]
    values = carried[idx]
    if cfg.error_feedback:
        new_err = torch.where(sent, torch.zeros_like(carried), carried)
    else:
        new_err = error_state
    return values, idx, new_err


def decompress_topk(values, idx, d: int):
    """``zeros([d]).at[idx].add(values)``."""
    return torch.zeros((d,), dtype=values.dtype,
                       device=values.device).index_add_(0, idx, values)


def compress_topk_batch(flats, cfg: CompressionConfig, error_states):
    """Per-party sparsification of a batch of updates.

    Args:
      flats: float32 ``[l, D]``, one flat update per live party.
      error_states: float32 ``[l, D]``, each party's residual.

    Returns ``(dense, new_error_states)``: the ``[l, D]`` densified top-k
    updates (``decompress_topk(compress_topk(...))`` per party: what the
    secure aggregation shares) and the new residuals, bit for bit the
    reference's.
    """
    flats = flats.to(torch.float32)
    error_states = error_states.to(torch.float32)
    carried = flats + error_states if cfg.error_feedback else flats
    sent = topk_mask(carried.abs(), top_k_count(carried.shape[1],
                                                cfg.top_k_ratio))
    zeros = torch.zeros_like(carried)
    # 0.0 + value: a sent -0.0 becomes +0.0, as the reference's add
    dense = torch.where(sent, carried, zeros) + zeros
    if cfg.error_feedback:
        new_err = torch.where(sent, zeros, carried)
    else:
        new_err = error_states
    return dense, new_err


def compressed_size(d: int, cfg: CompressionConfig) -> int:
    """Effective ``s`` after compression (elements shipped per party)."""
    if not cfg.enabled:
        return d
    # values + 1 index word per value
    return 2 * top_k_count(d, cfg.top_k_ratio)
