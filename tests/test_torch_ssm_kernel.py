"""The arithmetic of the redesigned selective-scan kernel, held against the
JAX package's reference on the CPU.

The CUDA kernel (``csrc/ssm_scan.cu``) runs only on the card, where
``chip_smoke.py`` holds it to its plain version.  Its order of operations
is kept testable here by a plain emulation in float32 PyTorch:

* the exponential as ``exp2(dt · (A·log2 e))``, with ``A·log2 e`` rounded
  to float32 once;
* the update with each product and the sum rounded,
  ``fl(fl(dA·h) + fl(fl(dt·x)·B))``;
* each channel's states split in two halves (the kernel's split over two
  threads), y summed over each half in order by fused multiply-adds from
  0 (each FMA emulated exactly in float64, then rounded once), then the
  two partial sums added, first plus second;
* a padded state (A = B = C = 0) where st is odd.

The emulation is held to the limits ``chip_smoke.py`` holds the kernel
to, 2e-5 + 1e-4 relative for float32 and 2e-2 for bf16 outputs, against
the JAX package's ``ssm_scan_ref`` and, at one shape, its Pallas kernel
in interpret mode.  The cases cover 1 to 8 states a thread (st 1..16).
Inputs come from numpy seeds, drawn as ``chip_smoke.py`` draws them: dt
a softplus of a normal around -4.6, A = -(1..st) · scale.

What the CPU cannot show: the last bits of ``ex2.approx.ftz`` (the
card's special-function unit; ``torch.exp2`` here rounds correctly) and
its flush of results below 2^-126 to 0.  The card covers those:
``chip_smoke.py`` compares the kernel with the plain version's
``torch.exp`` and, over its 4,096-step carry, with a float64 scan.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssm_scan.kernel import ssm_scan_pallas
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

#: chip_smoke.py's limits for the kernel against its plain version
F32_ATOL, F32_RTOL, BF16_ATOL = 2e-5, 1e-4, 2e-2
#: log2(e), the exponent's factor, as ``csrc/ssm_scan.cu`` spells it
LOG2E = math.log2(math.e)


def _inputs(b, s, di, st, a_scale, seed, dtype=torch.float32):
    """x, dt, B, C, A as numpy float32 arrays (x, B, C already rounded to
    ``dtype``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, di).astype(np.float32)
    dt = np.logaddexp(rng.randn(b, s, di) - 4.6, 0.0).astype(np.float32)
    bc = rng.randn(b, s, st).astype(np.float32)
    cc = rng.randn(b, s, st).astype(np.float32)
    a = np.tile(-(np.arange(1, st + 1, dtype=np.float32) * a_scale),
                (di, 1)).astype(np.float32)
    x, bc, cc = (torch.from_numpy(t).to(dtype).float().numpy()
                 for t in (x, bc, cc))
    return x, dt, bc, cc, a


def _fma(a, b, c):
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, and the float32 sum of it and c is rounded once
    (the float64 sum's own rounding is far below a float32 step)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_kernel(x, dt, bc, cc, a):
    """The kernel's float32 operations, in its order."""
    xf, dtf, bcf, ccf, af = (torch.from_numpy(t) for t in (x, dt, bc, cc, a))
    b, s, di = xf.shape
    st = af.shape[1]
    per = -(-st // 2)
    pad = 2 * per - st
    a2 = F.pad(af * LOG2E, (0, pad))
    bp, cp = F.pad(bcf, (0, pad)), F.pad(ccf, (0, pad))
    h = torch.zeros((b, di, 2 * per))
    ys = torch.empty((b, s, di))
    for t in range(s):
        dtt = dtf[:, t]
        da = torch.exp2(dtt[..., None] * a2[None])
        h = da * h + (dtt * xf[:, t])[..., None] * bp[:, t, None, :]
        halves = []
        for g in range(2):
            acc = torch.zeros((b, di))
            for n in range(g * per, (g + 1) * per):
                acc = _fma(h[..., n], cp[:, t, None, n], acc)
            halves.append(acc)
        ys[:, t] = halves[0] + halves[1]
    return ys


def _close(got, want, dtype):
    """chip_smoke.py's check: float32 to 2e-5 + 1e-4 relative; bf16
    outputs (both sides rounded to bf16) to 2e-2."""
    if dtype == torch.bfloat16:
        got = torch.from_numpy(np.array(got)).to(dtype).float()
        want = torch.from_numpy(np.array(want)).to(dtype).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)


CASES = {
    # (b, s, di, st, A scale, dtype)
    "st16": (2, 64, 64, 16, 1.0, torch.float32),
    "st12": (2, 48, 40, 12, 1.0, torch.float32),
    # st 7: the second half padded with one state
    "st7": (1, 48, 56, 7, 1.0, torch.float32),
    "st4": (2, 64, 48, 4, 1.0, torch.float32),
    "st1": (2, 48, 40, 1, 1.0, torch.float32),
    # a channel count off the kernel's 128 and st 5: padded states
    "ragged_st5": (1, 37, 72, 5, 1.0, torch.float32),
    "st16_bf16": (2, 64, 64, 16, 1.0, torch.bfloat16),
    "st2_bf16": (2, 48, 40, 2, 1.0, torch.bfloat16),
    "ragged_st3_bf16": (1, 41, 36, 3, 1.0, torch.bfloat16),
    # |A| 1e-3..1.6e-2 at dt ~ 0.01: h keeps ~all of its past, so the
    # carry decides every late output
    "carry_1024": (1, 1024, 64, 16, 1e-3, torch.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_matches_reference(case):
    b, s, di, st, a_scale, dtype = CASES[case]
    arrays = _inputs(b, s, di, st, a_scale, seed=s + di + st, dtype=dtype)
    want = np.asarray(j_ssm_scan_ref(*(jnp.asarray(t) for t in arrays)))
    got = emulate_kernel(*arrays)
    assert got.shape == (b, s, di) and bool(torch.isfinite(got).all())
    _close(got.numpy(), want, dtype)


def test_kernel_arithmetic_matches_pallas_kernel():
    # the reference's Pallas kernel in interpret mode, as its own tests
    # run it on the CPU (block_t divides S, block_d = di)
    arrays = _inputs(2, 64, 64, 16, 1.0, seed=7)
    want = np.asarray(ssm_scan_pallas(*(jnp.asarray(t) for t in arrays),
                                      block_t=32, interpret=True))
    got = emulate_kernel(*arrays)
    _close(got.numpy(), want, torch.float32)


@pytest.mark.parametrize("case", ["st16", "carry_1024"])
def test_kernel_arithmetic_matches_the_plain_version(case):
    # the port's plain version, which the kernel is held to on the card:
    # torch.exp of dt·A, and its einsum sums the states in its own order
    b, s, di, st, a_scale, dtype = CASES[case]
    arrays = _inputs(b, s, di, st, a_scale, seed=s + di + st, dtype=dtype)
    want = ssm_scan_ref(*(torch.from_numpy(t) for t in arrays))
    got = emulate_kernel(*arrays)
    _close(got.numpy(), want.numpy(), dtype)
