"""Plain PyTorch version of the fused additive share-generation kernel.

Contract (bit-exact for ``kernels/csrc/share_gen.cu``): for float32
updates ``x [l, D]`` and per-party keys ``[l, 2]``,

  1. ring encode ``u = encode(x)`` (``core.fixed_point``),
  2. masks ``M_j`` = Philox words with counter
     ``(counter_base + i//4, 0, j, 0)``, word ``i % 4``, j = 1..m-1,
  3. shares ``S_j = M_j`` (j < m), ``S_m = u - sum_j M_j`` (mod 2^32).

Returns ``int64`` words ``[l, m, D]``.  Runs on any device; the wrapper
sends it CPU tensors only.
"""

from __future__ import annotations

from repro_torch.core import additive
from repro_torch.core.field import u32
from repro_torch.core.fixed_point import FixedPointConfig


def share_gen_batch_ref(flats, m: int, keys, cfg: FixedPointConfig,
                        counter_base: int = 0):
    if cfg.algebra != "ring":
        raise ValueError("share_gen needs the ring codec")
    keys = u32(keys)
    shares = additive.share(cfg.encode(flats), m, keys[:, 0], keys[:, 1],
                            counter_base=counter_base)
    return shares.transpose(0, 1).contiguous()
