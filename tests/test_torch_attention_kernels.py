"""The arithmetic of the redesigned attention kernels, held against the JAX
package's references on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  What they compute differently from
a single pass is kept testable here:

* decode: the split plan (``split_plan``) and the fold of the splits'
  partials in split order (``fold_partials``, the fold kernel's plain
  version) equal the unsplit partials and the reference's
  ``decode_attention_ref``, acc, m and l to 1e-5 relative and absolute
  (the same sums cut at other places);
* flash in bf16: a plain emulation of the tensor-core kernel's
  arithmetic (bf16 q and k products summed in float32, the online
  softmax in the base-2 domain over 64- or 32-key tiles, P fed to the
  PV product as P_hi = bf16(P) and P_lo = bf16(P − P_hi) into a float32
  accumulator, the output rounded to bf16) stays within the limit that
  ``chip_smoke.py`` holds the kernel to: one bf16 step of each value
  (2^-7 relative) plus 2e-5.

Inputs come from numpy seeds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_decode_attention_ref
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.decode_attention.kernel import (SMS, SPLIT_KEYS,
                                                         split_plan)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      fold_partials)
from repro_torch.kernels.flash_attention.ref import NEG_INF, visible_mask

#: qwen1.5-0.5b's and recurrentgemma-9b's serve shapes: (batch, KV heads,
#: query rows a KV head)
SERVE_SHAPES = {"qwen": (8, 16, 1), "rg": (8, 1, 16)}
PARTIAL_TOL = 1e-5
#: chip_smoke.py's limit for the bf16 flash kernel
BF16_ATOL, BF16_STEP_RTOL = 2e-5, 2.0 ** -7


# ---------------------------------------------------------------------------
# decode: the split plan and the fold
# ---------------------------------------------------------------------------

def split_ranges(b, hkv, kv_len, group):
    """The key range ``[start, stop)`` each block of the split kernel
    takes (``csrc/decode_attention.cu``: split ``i`` from ``i·chunk`` to
    ``min(kv_len, (i+1)·chunk)``), in split order."""
    splits, chunk = split_plan(b, hkv, kv_len, group)
    return [(i * chunk, min(kv_len, (i + 1) * chunk)) for i in range(splits)]


@pytest.mark.parametrize("shape", sorted(SERVE_SHAPES))
@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 640, 1000, 2048])
def test_split_plan_covers_the_cache_once(shape, kv_len):
    b, hkv, group = SERVE_SHAPES[shape]
    splits, chunk = split_plan(b, hkv, kv_len, group)
    ranges = split_ranges(b, hkv, kv_len, group)
    assert len(ranges) == splits and chunk % SPLIT_KEYS == 0
    # contiguous, in order, none empty, exactly [0, kv_len)
    assert ranges[0][0] == 0 and ranges[-1][1] == kv_len
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    covered = np.zeros(kv_len, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # every split but the last takes a whole chunk, the last the rest
    assert all(hi - lo == chunk for lo, hi in ranges[:-1])
    assert 1 <= ranges[-1][1] - ranges[-1][0] <= chunk
    # the grid stays within one wave of blocks (one row a KV head) or two
    # (a group), and no split is shorter than SPLIT_KEYS unless the whole
    # cache is: one split at kv_len 1
    assert splits * b * hkv <= (1 if group == 1 else 2) * SMS
    if kv_len <= SPLIT_KEYS:
        assert splits == 1


def test_split_plan_at_the_serve_shapes():
    # recurrentgemma-9b's 8 (KV head, row) pairs: 32 splits of 64 keys,
    # 256 blocks at kv_len 2,048, and 1,000 ends in a ragged split of 8
    assert split_plan(8, 1, 2048, 16) == (32, 64)
    assert split_ranges(8, 1, 1000, 16)[-1] == (992, 1000)
    assert split_plan(8, 1, 192, 16) == (12, 16)
    # qwen1.5-0.5b's 128 pairs of one row each already make a wave: one
    # split, no fold
    assert split_plan(8, 16, 640, 1) == (1, 640)
    # a smaller batch of one-row heads splits to fill the wave
    assert split_plan(2, 4, 73, 1) == (5, 16)


def _decode_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32))


# (name, b, hq, hkv, s, d, kv_len): the serve shapes' heads and head dims
# at a smoke batch; kv_len past one split, with a ragged last one
FOLD_CASES = [
    ("qwen", 2, 4, 4, 80, 64, 73),
    ("qwen_one_split", 2, 4, 4, 80, 64, 9),
    ("rg", 2, 16, 1, 96, 256, 70),
]


@pytest.mark.parametrize("name,b,hq,hkv,s,d,kv_len", FOLD_CASES)
def test_split_partials_fold_to_the_reference(name, b, hq, hkv, s, d,
                                              kv_len):
    q, k, v = _decode_inputs(len(name) + kv_len, b, hq, hkv, s, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ranges = split_ranges(b, hkv, kv_len, hq // hkv)
    assert (len(ranges) > 1) == (kv_len > SPLIT_KEYS)
    # each split's partials: its key range, the rest masked off
    parts = [decode_attention_ref(tq, tk[:, :, lo:hi], tv[:, :, lo:hi])
             for lo, hi in ranges]
    acc, m, l = fold_partials(*(torch.stack(p) for p in zip(*parts)))
    whole = decode_attention_ref(tq, tk, tv, kv_len=kv_len)
    want = j_decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), kv_len=kv_len)
    for got, plain, ref in zip((acc, m, l), whole, want):
        np.testing.assert_allclose(got.numpy(), plain.numpy(),
                                   rtol=PARTIAL_TOL, atol=PARTIAL_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=PARTIAL_TOL, atol=PARTIAL_TOL)


# ---------------------------------------------------------------------------
# flash, bf16: the tensor-core kernel's P arithmetic
# ---------------------------------------------------------------------------

def flash_bf16_emulation(q, k, v, *, causal, window, block_k):
    """The bf16 kernel's arithmetic in plain torch: bf16 ``q``, ``k``,
    ``v`` ``[B,H,S,D]`` -> bf16 output."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    # scale·log2 e, rounded to float32 as the launch computes it
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    vis = visible_mask(sq, skv, causal, window, q.device)
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, block_k):
        sl = slice(k0, k0 + block_k)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk[:, :, sl]) \
            * scale_log2
        s = torch.where(vis[:, sl], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis[:, sl], torch.exp2(s - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        acc = (acc * alpha[..., None]
               + torch.einsum("bhqk,bhkd->bhqd", p_hi, vv[:, :, sl])
               + torch.einsum("bhqk,bhkd->bhqd", p_lo, vv[:, :, sl]))
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).bfloat16()


# (b, hq, hkv, sq, skv, d, causal, window, block_k): qwen1.5-0.5b's D 64
# (causal, 64-key tiles) and recurrentgemma-9b's D 256 (16 query heads on
# one KV head, a binding window, 32-key tiles), at smoke lengths
EMULATION_CASES = [
    (2, 4, 4, 160, 160, 64, True, 0, 64),
    (1, 16, 1, 96, 96, 256, True, 40, 32),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,block_k",
                         EMULATION_CASES)
def test_flash_bf16_p_split_within_one_bf16_step(b, hq, hkv, sq, skv, d,
                                                 causal, window, block_k):
    rng = np.random.RandomState(d + window)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .bfloat16() for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                         (b, hkv, skv, d)))
    got = flash_bf16_emulation(q, k, v, causal=causal, window=window,
                               block_k=block_k).float()
    want = np.asarray(j_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        causal=causal, window=window))
    want = torch.from_numpy(np.array(want)).bfloat16().float()
    err = (got - want).abs()
    assert bool((err <= BF16_ATOL + BF16_STEP_RTOL * want.abs()).all()), \
        float(err.max())
