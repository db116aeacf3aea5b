from .ops import shamir_share, shamir_share_batch, shamir_reconstruct
from .ref import (shamir_share_ref, shamir_share_batch_ref,
                  shamir_reconstruct_ref)
from .kernel import (shamir_share_cuda, shamir_share_batch_cuda,
                     shamir_reconstruct_cuda)

__all__ = ["shamir_share", "shamir_share_batch", "shamir_reconstruct",
           "shamir_share_ref", "shamir_share_batch_ref",
           "shamir_reconstruct_ref", "shamir_share_cuda",
           "shamir_share_batch_cuda", "shamir_reconstruct_cuda"]
