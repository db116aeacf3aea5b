from .ops import reconstruct
from .ref import reconstruct_ref
from .kernel import reconstruct_cuda

__all__ = ["reconstruct", "reconstruct_ref", "reconstruct_cuda"]
