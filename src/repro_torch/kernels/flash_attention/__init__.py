from .ops import flash_attention
from .ref import attention_ref
from .kernel import flash_attention_cuda

__all__ = ["flash_attention", "attention_ref", "flash_attention_cuda"]
