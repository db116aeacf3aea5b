"""Core MPC library of the port: algebra, sharing, election, aggregation."""

from .aggregation import SecureAggregator, flatten, secure_mean_pytrees
from .committee import ElectionResult, elect
from .costmodel import CostParams
from .fixed_point import DEFAULT_FIELD, DEFAULT_RING, FixedPointConfig

__all__ = [
    "SecureAggregator", "flatten", "secure_mean_pytrees",
    "ElectionResult", "elect", "CostParams",
    "FixedPointConfig", "DEFAULT_RING", "DEFAULT_FIELD",
]
