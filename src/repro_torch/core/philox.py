"""Counter-based Philox4x32-10 on ``int64``-carried words.

Counterpart of ``repro/core/philox.py``: the same rounds, constants and
counter layout, so every mask, coefficient, key and vote matches the
reference bit for bit.  The functions broadcast over tensors of keys, so
one call draws the streams of a whole batch of parties.  The CUDA kernels
run the same rounds in ``kernels/csrc/philox.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import U32_MASK, mulhilo32, u32

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_N_ROUNDS = 10

#: key of the one Philox call that whitens (seed, stream) into a key
DERIVE_KEY = (0x243F6A88, 0x85A308D3)


def _broadcast(*shapes) -> tuple[int, ...]:
    """The broadcast of ``shapes``.  numpy's rule, which is torch's:
    ``torch.broadcast_shapes`` imports sympy on its first call (~1 s),
    which a party worker would pay in its first election."""
    return np.broadcast_shapes(*(tuple(sh) for sh in shapes))


def philox_4x32_tuple(x0, x1, x2, x3, key0, key1):
    """Four counter-word tensors in, four random-word tensors out.

    All arguments broadcast against each other (ints or ``int64``
    words).
    """
    k0 = u32(key0)
    k1 = u32(key1)
    x0, x1, x2, x3 = (u32(x) for x in (x0, x1, x2, x3))
    for _ in range(_N_ROUNDS):
        hi0, lo0 = mulhilo32(PHILOX_M0, x0)
        hi1, lo1 = mulhilo32(PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & U32_MASK
        k1 = (k1 + PHILOX_W1) & U32_MASK
    return x0, x1, x2, x3


def philox_4x32(counters, key0, key1):
    """Counters ``[..., 4]`` -> random words ``[..., 4]``."""
    counters = u32(counters)
    y = philox_4x32_tuple(*(counters[..., i] for i in range(4)), key0, key1)
    return torch.stack(y, dim=-1)


def random_bits(n: int, key0, key1, counter_hi=0, counter_base=0,
                device=None, layout: str = "flat"):
    """``n`` words of the keyed stream, per key.

    The counter of block ``c`` is ``(counter_base + c, 0, counter_hi, 0)``
    (mod 2^32), word ``i`` is word ``i % 4`` of block ``i // 4`` — the
    reference's layout.  ``layout="tiled"`` moves ``counter_hi`` to the
    second counter word, ``(counter_base + c, counter_hi, 0, 0)``: the
    stream of the reference's single-party kernels
    (``philox.tiled_words``, whose lane-tiled ``[R, 128]`` view is this
    flat stream row by row).  ``key0``/``key1`` may be ints or ``int64``
    tensors of one shape ``B``; the result is ``[*B, n]``.
    """
    if layout not in ("flat", "tiled"):
        raise ValueError(f"unknown counter layout {layout!r}")
    k0 = u32(key0)
    k1 = u32(key1)
    if device is None:
        device = k0.device
    k0 = k0.to(device)[..., None]
    k1 = k1.to(device)[..., None]
    n_blocks = -(-n // 4)
    c = (torch.arange(n_blocks, dtype=torch.int64, device=device)
         + int(counter_base)) & U32_MASK
    zero = torch.zeros_like(c)
    hi = int(counter_hi) & U32_MASK
    if layout == "flat":
        y = philox_4x32_tuple(c, zero, hi, zero, k0, k1)
    else:
        y = philox_4x32_tuple(c, hi, zero, zero, k0, k1)
    y = [w.expand(*_broadcast(k0.shape, c.shape)) for w in y]
    return torch.stack(y, dim=-1).flatten(-2)[..., :n]


def random_bits_like(x, key0, key1, counter_hi=0, counter_base=0):
    """Words with the shape of ``x`` from one keyed stream, in the
    row-major order of ``x`` (scalar keys)."""
    flat = random_bits(max(x.numel(), 1), key0, key1, counter_hi=counter_hi,
                       counter_base=counter_base, device=x.device)
    return flat[:x.numel()].reshape(x.shape)


def derive_key(seed, stream):
    """Stateless ``(key0, key1)`` from a seed and a stream id.

    ``seed``/``stream`` may be Python ints (both 32-bit halves are
    used), ``int64`` word tensors (the high word is 0), or explicit
    ``(lo, hi)`` pairs of either.  Tensors broadcast; the keys come back
    as ``int64`` words of the broadcast shape, on the device of the
    tensor arguments.  Ints stay host scalars, which every device's ops
    take without a copy, so deriving keys for a tensor of stream ids on
    the card never waits for the card.
    """
    def split(v):
        if isinstance(v, tuple):
            lo, hi = v
            return u32(lo), u32(hi)
        if isinstance(v, (int, np.integer)):
            v = int(v)
            return (torch.tensor(v & U32_MASK),
                    torch.tensor((v >> 32) & U32_MASK))
        v = u32(v)
        return v, torch.zeros_like(v)

    s_lo, s_hi = split(seed)
    t_lo, t_hi = split(stream)
    parts = (s_lo, s_hi, t_lo, t_hi)
    device = next((p.device for p in parts if p.device.type != "cpu"),
                  torch.device("cpu"))
    # 0-d host tensors broadcast against tensors of any device
    parts = [p if p.ndim == 0 else p.to(device) for p in parts]
    shape = _broadcast(*(p.shape for p in parts))
    w0, w1, _, _ = philox_4x32_tuple(*parts, *DERIVE_KEY)
    return w0.expand(shape), w1.expand(shape)


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def np_philox_4x32(counters, key0, key1):
    """Philox4x32-10 in numpy ``uint64`` arithmetic: ``[..., 4]`` words."""
    counters = np.asarray(counters, dtype=np.uint32)
    x = [counters[..., i].astype(np.uint64) for i in range(4)]
    k0 = np.uint64(int(key0))
    k1 = np.uint64(int(key1))
    mask = np.uint64(U32_MASK)
    for _ in range(_N_ROUNDS):
        p0 = np.uint64(PHILOX_M0) * x[0]
        p1 = np.uint64(PHILOX_M1) * x[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & mask
        hi1, lo1 = p1 >> np.uint64(32), p1 & mask
        x = [hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0]
        k0 = (k0 + np.uint64(PHILOX_W0)) & mask
        k1 = (k1 + np.uint64(PHILOX_W1)) & mask
    return np.stack([xi.astype(np.uint32) for xi in x], axis=-1)
