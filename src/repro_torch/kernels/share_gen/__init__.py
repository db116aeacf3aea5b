from .ops import share_gen, share_gen_batch
from .ref import share_gen_ref, share_gen_batch_ref
from .kernel import share_gen_cuda, share_gen_batch_cuda

__all__ = ["share_gen", "share_gen_batch", "share_gen_ref",
           "share_gen_batch_ref", "share_gen_cuda", "share_gen_batch_cuda"]
