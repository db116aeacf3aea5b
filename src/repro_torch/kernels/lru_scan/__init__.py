from .ops import lru_scan
from .ref import lru_scan_ref
from .kernel import lru_scan_cuda

__all__ = ["lru_scan", "lru_scan_ref", "lru_scan_cuda"]
