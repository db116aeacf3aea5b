"""Plain PyTorch version of the batched Feldman verification kernel.

Contract (bit-exact for ``kernels/csrc/verify_shares.cu``): for rows
``[k, D]`` (field words at ``points[i]``) and element-major commitments
``[D, c, 2]`` (``(hi, lo)`` words, ``c = degree + 1``), return ``int32``
flags ``[k, D]``, 1 where ``h^{row_i[e]} == Π_j C_j[e]^{points[i]^j}
(mod q)`` — ``core.vss.verify_share`` per row.  Both take ``int64``
words or ``int32`` bit patterns.
"""

from __future__ import annotations

import torch

from repro_torch.core import vss


def verify_shares_ref(rows, commits, points: tuple[int, ...]):
    return torch.stack([vss.verify_share(rows[i], commits, int(points[i]))
                        for i in range(rows.shape[0])]).to(torch.int32)
