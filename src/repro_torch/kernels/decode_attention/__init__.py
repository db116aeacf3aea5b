from .ops import decode_attention, decode_attention_partial
from .ref import decode_attention_ref, combine_partials
from .kernel import decode_attention_cuda

__all__ = ["decode_attention", "decode_attention_partial",
           "decode_attention_ref", "combine_partials",
           "decode_attention_cuda"]
