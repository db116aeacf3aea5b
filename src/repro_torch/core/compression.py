"""Top-k compression settings ahead of secret sharing.

The ``CompressionConfig`` dataclass of ``repro/core/compression.py``,
which the typed experiment API (``repro_torch.api``) converts to.  The
compression itself (``compress_topk`` and its batch form, with error
feedback) is a later slice of the port (ROADMAP queue 1, item 6): a
transport handed an enabled config raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    top_k_ratio: float = 0.01     # fraction of coordinates kept
    error_feedback: bool = True

    def __post_init__(self):
        if not 0.0 < self.top_k_ratio <= 1.0:
            raise ValueError(
                f"top_k_ratio={self.top_k_ratio} must be in (0, 1]")
