from .ops import ssm_scan
from .ref import ssm_scan_ref
from .kernel import ssm_scan_cuda

__all__ = ["ssm_scan", "ssm_scan_ref", "ssm_scan_cuda"]
