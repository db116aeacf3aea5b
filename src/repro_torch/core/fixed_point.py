"""Float <-> fixed-point codec for secret-shared aggregation.

Counterpart of ``repro/core/fixed_point.py``: ``x`` is encoded as
``round(clip(x) * 2**frac_bits)`` in two's complement (ring) or as a
field element with negatives at ``p - |q|`` (field), summed under the
scheme, decoded and divided by the party count.  Codewords are
``int64`` words (``core.field``).

Two places where PyTorch would otherwise differ from the reference's
XLA bits are pinned here and in ``kernels/csrc/fixed_point.cuh``:

* NaN encodes to 0, as XLA's float -> int32 conversion gives; torch's
  ``.to(torch.int32)`` of NaN gives ``0x80000000``;
* the mean divides by ``n`` with an IEEE division by a tensor
  (``true_div``): on the card, torch divides a tensor by a Python
  scalar as a multiply by the reciprocal, which can be one ulp off.

Rounding agrees as it stands: ``torch.round`` rounds half to even, like
``jnp.round``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .field import MERSENNE_P, U32_MASK, u32


def true_div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` in float32 as one IEEE division on every device.

    The divisor is a 0-d tensor on ``x``'s device (filled there, so the
    card is not waited for): CUDA divides a tensor by a Python float as
    a multiply by its reciprocal, which is not the same float.
    """
    return x / torch.full((), float(n), dtype=torch.float32,
                          device=x.device)


@dataclasses.dataclass(frozen=True)
class FixedPointConfig:
    """Quantization contract: ``frac_bits``, symmetric ``clip``, and
    ``algebra`` (``"ring"`` for additive sharing, ``"field"`` for
    Shamir)."""

    frac_bits: int = 16
    clip: float = 64.0
    algebra: str = "ring"

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def modulus(self) -> int:
        return 2 ** 32 if self.algebra == "ring" else MERSENNE_P

    def max_parties(self) -> int:
        """Largest n for which a sum of encoded values cannot wrap.

        In the ring ``+2^31`` is the sign bit, so the largest decodable
        positive sum is ``2^31 - 1``; in the field ``(p-1)/2`` itself
        decodes positively.
        """
        half = self.modulus // 2
        limit = half - 1 if self.algebra == "ring" else half
        return int(limit // (self.clip * self.scale))

    def validate_for_parties(self, n: int) -> None:
        if n > self.max_parties():
            raise ValueError(
                f"fixed-point headroom violated: n={n} parties with "
                f"clip={self.clip}, frac_bits={self.frac_bits} allows at "
                f"most {self.max_parties()} parties; lower clip or "
                f"frac_bits")

    def quantize(self, x) -> torch.Tensor:
        """float -> signed ``int64`` q = round(clip(x) * scale), NaN -> 0."""
        x = torch.as_tensor(x, dtype=torch.float32)
        q = torch.round(torch.clamp(x, -self.clip, self.clip) * self.scale)
        return torch.nan_to_num(q, nan=0.0).to(torch.int64)

    def encode(self, x) -> torch.Tensor:
        """float tensor -> ``int64`` codewords."""
        q = self.quantize(x)
        if self.algebra == "ring":
            return q & U32_MASK
        return torch.where(q < 0, q + MERSENNE_P, q)

    def decode(self, w, count: int = 1) -> torch.Tensor:
        """Codewords (a sum of ``count`` encodings) -> float32 sum."""
        w = u32(w)
        if self.algebra == "ring":
            signed = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
            return signed.to(torch.float32) / self.scale
        is_neg = w > MERSENNE_P // 2
        mag = torch.where(is_neg, MERSENNE_P - w, w).to(torch.float32)
        return torch.where(is_neg, -mag, mag) / self.scale

    def decode_mean(self, w, n: int) -> torch.Tensor:
        """Decode a sum of ``n`` encodings into their mean."""
        return true_div(self.decode(w, count=n), n)

    def quant_error_bound(self, n: int = 1) -> float:
        """Worst-case |decode(sum encode) - sum| = n * 0.5 ulp."""
        return float(n) * 0.5 / self.scale


DEFAULT_RING = FixedPointConfig(frac_bits=16, clip=64.0, algebra="ring")
DEFAULT_FIELD = FixedPointConfig(frac_bits=16, clip=64.0, algebra="field")


def np_encode(cfg: FixedPointConfig, x):
    """numpy oracle of ``encode`` (finite inputs)."""
    x = np.clip(np.asarray(x, dtype=np.float32), -cfg.clip, cfg.clip)
    q = np.round(x * cfg.scale).astype(np.int64)
    return (q % cfg.modulus).astype(np.uint32)
