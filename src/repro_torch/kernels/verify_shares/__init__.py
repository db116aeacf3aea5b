from .ops import verify_shares
from .ref import verify_shares_ref
from .kernel import verify_shares_cuda

__all__ = ["verify_shares", "verify_shares_ref", "verify_shares_cuda"]
