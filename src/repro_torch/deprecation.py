"""Deprecation policy of the port's public surface.

A copy of ``repro/deprecation.py``: old configuration paths (the
``FedAvgConfig.agg_kwargs`` dict) keep working behind shims that emit
:class:`ReproDeprecationWarning`, so a run can escalate exactly these
shims to errors (``-W error::repro_torch.deprecation.
ReproDeprecationWarning``) without tripping over third-party
deprecations.
"""

from __future__ import annotations

import warnings

__all__ = ["ReproDeprecationWarning", "warn_deprecated"]


class ReproDeprecationWarning(DeprecationWarning):
    """A deprecated configuration path of the port was used."""


def warn_deprecated(message: str) -> None:
    warnings.warn(message, ReproDeprecationWarning, stacklevel=3)
