#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each a hard check (any failure raises, and the script exits
non-zero without the final result line):

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each of the four kernels of the two-phase round against its
   plain PyTorch version on the same CUDA tensors at the main-path
   shapes (a party chunk of l=1024, m=3, D=10,000, plus a ragged
   D=10,001 with a non-zero counter offset): ``torch.equal`` on the bit
   patterns, then median times from CUDA events beside the bound;
   then the Feldman check ``verify_shares`` at the member-row shape
   (k=3, D=10,000), a ragged D=10,001 and the audit shape (k=3,
   D=1,024 x 10,000), each with a known set of tampered elements;
4. rounds: the two-phase round at n=10,000 parties and s=10,000
   elements, additive and Shamir, through ``make_transport`` on the
   card, with counters against Eqs. 3-6, the mean bit for bit against
   the same round through the plain versions on the card, and within
   the fixed-point rounding of the float64 plain mean;
5. vss: the malicious-secure round (Feldman VSS, per-round
   re-election) at n=2,048, s=10,000: an honest round, then a member
   tampering with ``flip``, ``wrong_poly`` and ``replay`` in turn,
   each blamed, evicted and re-elected away with the honest mean;
6. audit: the norm-bound dealer audit at n=1,024, s=10,000 with a
   ``scale`` and a ``sign_flip`` dealer, both blamed, and a
   ``malformed`` dealer that fails the round;
7. streaming: chunked aggregation equals the whole vector, and the card
   equals the port's CPU path, bit for bit;
8. FedAvg: ``run_fedavg`` on SimpleNN with 8 parties on the card;
9. single-party kernels: ``share_gen`` and ``shamir_share`` (the SPMD
   path's share kernels) against their plain versions, ``torch.equal``,
   at the train path's largest leaf (D = 155,582,464, m = 3, degree 2)
   and at a ragged D = 10,001 with ``hi_base`` 192, with times and
   bounds;
10. spmd: four ``gloo`` ranks on the one card (ranks share it, so the
    backend rule picks gloo; ``reduce_scatter`` and ``all_gather`` stage
    through host memory): every mode and scheme of
    ``fl.spmd.secure_aggregate``, each rank's mean bit-identical to the
    others and, in the secure modes, to the same aggregation composed
    from the plain versions on the card; then two train steps of the
    smoke config, with identical parameters on every rank;
11. train: the federated LM trainer (``launch.train``) on qwen1.5-0.5b
    at full width and depth, a world of one, global batch 8 x seq 128,
    four steps each of ``plain``, ``two_phase`` additive and
    ``two_phase`` Shamir: every step's aggregated gradient, leaf by leaf,
    bit-identical to decode(encode(g)) composed from the plain versions
    on the card; 14 launches of the scheme's share and reconstruct
    kernels per secure step; loss, step wall time and tok/s per step
    (the check's time taken out: the trainer's own "tok/s" lines count
    it), then one profiled step split into its ``fwd_bwd``,
    ``secure_aggregate`` and ``adamw_update`` ranges and one unchecked
    step with its peak device memory;
12. summary: a ``{"kernels": [...]}`` line, then the result line.

Every phase prints one JSON object per line.  The script imports no JAX
and nothing of the JAX package.  It needs one card and no network.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` trace of
one n=10,000 round per scheme after the checks: the device time by
kernel name and the device's busy share of the round; and of one VSS
round, with its device time split between commitment generation,
member sums and verification.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 operations per second of an H100 SXM at its 700 W limit, derived
#: from the data sheet's 67 TFLOP/s float32 (a fused multiply-add counts
#: as two): 33.5e12 float32 lane operations/s, and a Hopper SM has 64
#: INT32 lanes against 128 float32 lanes.
INT32_OPS_PER_S = 67e12 / 2 / 2
#: integer operations per Philox4x32-10 call (four words): ten rounds of
#: two multiply-lows, two multiply-highs, four xors and two key adds
PHILOX_OPS = 100
#: integer operations of the field steps, as ``kernels/csrc/mersenne.cuh``
#: spells them out: fmul, fadd and to_field
FIELD_MUL_OPS = 12
FIELD_ADD_OPS = 6
TO_FIELD_OPS = 3
#: integer operations of F_q, q = 2^59 - 2^28 + 1, as
#: ``kernels/csrc/fq.cuh`` spells them out (one per 64-bit source
#: operation): qmul 20; a step of the fixed-base ladder is a qmul, a
#: shift, an and and a select
QMUL_OPS = 20
LADDER_STEP_OPS = QMUL_OPS + 3
#: h^s: the first bit is a select, then 30 ladder steps
GPOW_OPS = 2 + 30 * LADDER_STEP_OPS


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, int_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(smi, "nvidia-smi printed no card")
    print(smi[0], flush=True)
    emit({"phase": "device", "nvidia_smi": smi[0],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi[0]


def phase_build() -> None:
    from repro_torch.kernels import dispatch
    t0 = time.perf_counter()
    info = dispatch.load_library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": info["built"], "ptxas": ptxas})
    # ptxas prints a kernel's stack line after its "entry function" line:
    # the single-party kernels must keep everything in registers
    lines = info["log"].splitlines()
    for kernel in ("share_gen_kernel", "shamir_share_kernel"):
        at = [i for i, ln in enumerate(lines)
              if "entry function" in ln and f"{kernel}E" in ln]
        require(len(at) == 1, f"ptxas printed no entry for {kernel}")
        frame = next((ln for ln in lines[at[0] + 1:]
                      if "stack frame" in ln), "")
        require(frame.strip().startswith("0 bytes stack frame"),
                f"{kernel} uses a stack frame: {frame.strip()!r}")


def _bits(t):
    """32-bit patterns of a float32, int32 or int64-word tensor."""
    import torch
    from repro_torch.core.field import to_i32
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    return to_i32(t)


def _keys(seed: int, ids):
    import torch
    from repro_torch.core import philox
    k0, k1 = philox.derive_key(seed, torch.as_tensor(ids, dtype=torch.int64))
    return torch.stack([k0, k1], dim=1).cuda()


def phase_kernels() -> dict:
    """Kernels against their plain versions; returns timing rows."""
    import torch
    from repro_torch.core.field import MERSENNE_P, U32_MASK, to_i32
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.kernels.reconstruct import reconstruct, reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct,
                                            shamir_reconstruct_ref,
                                            shamir_share_batch,
                                            shamir_share_batch_ref)
    from repro_torch.kernels.share_gen import (share_gen_batch,
                                               share_gen_batch_ref)
    ring = FixedPointConfig(frac_bits=10, clip=64.0, algebra="ring")
    field = FixedPointConfig(frac_bits=10, clip=64.0, algebra="field")
    l, m = 1024, 3
    rows = {}
    rng = np.random.RandomState(0)
    for d, counter_base in ((10_000, 0), (10_001, 250)):
        x_np = (rng.randn(l, d) * 0.1).astype(np.float32)
        x_np[0, :5] = [np.nan, np.inf, -np.inf, 0.5 / 1024, 1.5 / 1024]
        x = torch.from_numpy(x_np).cuda()
        keys64 = _keys(1, np.arange(l))
        keys = to_i32(keys64).contiguous()
        timed = d == 10_000

        def check(name, got, want, plain_fn, kernel_fn, nbytes, ops,
                  reps=20):
            same = torch.equal(_bits(got), _bits(want))
            if got.dtype == torch.float32:
                err = float((got - want).abs().max())
            else:
                err = float((got.to(torch.int64) & U32_MASK)
                            .sub(want.to(torch.int64) & U32_MASK)
                            .abs().max())
            require(same, f"{name}: kernel differs from its plain version "
                          f"at D={d} (max abs err {err})")
            entry = {"phase": "kernel", "name": name, "d": d,
                     "counter_base": counter_base, "equal": True,
                     "max_abs_err": err}
            if timed:
                b_ms, b_by = bound(nbytes, ops)
                entry.update(ms=cuda_ms(kernel_fn, reps),
                             plain_ms=cuda_ms(plain_fn, 3),
                             bound_ms=b_ms, bound_by=b_by)
                rows[name] = entry
            emit(entry)

        quads = -(-d // 4)
        # additive shares
        sg = share_gen_batch(x, m, keys, ring, counter_base)
        sg_ref = share_gen_batch_ref(x, m, keys64, ring, counter_base)
        check("share_gen_batch", sg, to_i32(sg_ref),
              lambda: share_gen_batch_ref(x, m, keys64, ring, counter_base),
              lambda: share_gen_batch(x, m, keys, ring, counter_base),
              4 * l * d + 8 * l + 4 * l * m * d,
              l * quads * (m - 1) * PHILOX_OPS + l * d * (m - 1))
        # Shamir shares, degree m - 1
        deg = m - 1
        ss = shamir_share_batch(x, m, keys, field, None, counter_base)
        ss_ref = shamir_share_batch_ref(x, m, keys64, field, None,
                                        counter_base)
        check("shamir_share_batch", ss, to_i32(ss_ref),
              lambda: shamir_share_batch_ref(x, m, keys64, field, None,
                                             counter_base),
              lambda: shamir_share_batch(x, m, keys, field, None,
                                         counter_base),
              4 * l * d + 8 * l + 4 * l * m * d,
              # deg coefficients drawn once; Horner at x = 1..m is deg
              # multiply-adds per point
              l * quads * deg * PHILOX_OPS
              + l * d * (deg * TO_FIELD_OPS
                         + m * deg * (FIELD_MUL_OPS + FIELD_ADD_OPS)))
        # member sums of the chunk, then the two reconstructions at n = 1
        ring_sums = to_i32(sg.sum(0, dtype=torch.int64) & U32_MASK)
        field_sums = to_i32(ss.sum(0, dtype=torch.int64) % MERSENNE_P)
        check("reconstruct", reconstruct(ring_sums, 1, ring),
              reconstruct_ref(ring_sums, 1, ring),
              lambda: reconstruct_ref(ring_sums, 1, ring),
              lambda: reconstruct(ring_sums, 1, ring),
              4 * m * d + 4 * d, (m - 1) * d, reps=50)
        check("shamir_reconstruct", shamir_reconstruct(field_sums, 1, field),
              shamir_reconstruct_ref(field_sums, 1, field),
              lambda: shamir_reconstruct_ref(field_sums, 1, field),
              lambda: shamir_reconstruct(field_sums, 1, field),
              4 * m * d + 4 * m + 4 * d,
              d * (m * FIELD_MUL_OPS + (m - 1) * FIELD_ADD_OPS), reps=50)
        # sub-threshold reconstruction from points (1, 3) of a degree-1
        # polynomial
        ss1 = shamir_share_batch(x, m, keys, field, 1, counter_base)
        require(torch.equal(_bits(ss1), to_i32(shamir_share_batch_ref(
            x, m, keys64, field, 1, counter_base))),
            f"shamir_share_batch degree 1 differs at D={d}")
        sub = to_i32(ss1[:, [0, 2]].sum(0, dtype=torch.int64) % MERSENNE_P)
        require(torch.equal(
            _bits(shamir_reconstruct(sub, 1, field, points=(1, 3))),
            _bits(shamir_reconstruct_ref(sub, 1, field, points=(1, 3)))),
            f"shamir_reconstruct at points (1, 3) differs at D={d}")
        del sg, ss, ss1, sg_ref, ss_ref
    torch.cuda.synchronize()
    return rows


def verify_ops(points, c: int) -> int:
    """Integer operations of one element of ``verify_shares`` over its
    rows: the ladder, the Horner in the exponent (``qpow`` by point x is
    bitlen(x) - 1 squarings and popcount(x) - 1 multiplies), and the
    comparison."""
    total = 0
    for x in points:
        qpow = (x.bit_length() - 1) + (bin(x).count("1") - 1)
        total += GPOW_OPS + (c - 1) * (qpow + 1) * QMUL_OPS + 1
    return total


def phase_verify_kernel() -> dict:
    """``verify_shares`` against its plain version at the member-row,
    ragged and audit shapes; returns the timing rows."""
    import torch
    from repro_torch.core import philox, shamir
    from repro_torch.core.field import MERSENNE_P, to_i32
    from repro_torch.fl.faults import TAMPER_FLIP_MASK
    from repro_torch.kernels.verify_shares import (verify_shares,
                                                   verify_shares_ref)
    points, c = (1, 2, 3), 2
    rows_out = {}
    for shape, d in (("member", 10_000), ("ragged", 10_001),
                     ("audit", 1024 * 10_000)):
        gen = torch.Generator(device="cuda").manual_seed(d)
        v = torch.randint(0, MERSENNE_P, (d,), device="cuda", generator=gen)
        k0, k1 = philox.derive_key(5, d)
        shares, commits = shamir.share_with_commitments(v, 3, k0, k1,
                                                        degree=c - 1)
        rows = to_i32(shares).contiguous()
        cm = to_i32(commits).contiguous()
        del v, shares, commits
        # a known set of tampered elements: every 997th of row 1, and
        # the first and last of row 2
        bad = torch.arange(7, d, 997, device="cuda")
        rows[1, bad] ^= TAMPER_FLIP_MASK
        rows[2, [0, d - 1]] ^= TAMPER_FLIP_MASK
        n_bad = bad.numel() + 2
        got = verify_shares(rows, cm, points)
        want = verify_shares_ref(rows, cm, points)
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        require(same, f"verify_shares differs from its plain version at "
                      f"{shape} D={d} (max abs err {err})")
        zeros = int((got == 0).sum())
        require(zeros == n_bad,
                f"verify_shares at D={d}: {zeros} elements fail, "
                f"{n_bad} were tampered")
        entry = {"phase": "kernel", "name": "verify_shares", "shape": shape,
                 "k": len(points), "d": d, "equal": True,
                 "max_abs_err": err, "flags_zero": zeros,
                 "tampered": n_bad}
        if shape != "ragged":
            b_ms, b_by = bound(
                4 * len(points) * d * 2 + 8 * c * d + 4 * len(points),
                d * verify_ops(points, c))
            entry.update(ms=cuda_ms(lambda: verify_shares(rows, cm, points),
                                    20),
                         plain_ms=cuda_ms(
                             lambda: verify_shares_ref(rows, cm, points), 3),
                         bound_ms=b_ms, bound_by=b_by)
            rows_out[shape] = entry
        emit(entry)
        del rows, cm, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows_out


def plain_round_mean(flats, scheme: str, fp, m: int, seed: int,
                     chunk: int, ids=None):
    """A round-0 mean at full committee, recomputed on the card through
    the plain share and reconstruct versions, party chunk by party chunk,
    with a fold of its own: what the transport's chunk loop, key
    derivation and fold must reproduce bit for bit."""
    import torch
    from repro_torch.core import philox
    from repro_torch.core.field import MERSENNE_P, U32_MASK, fadd
    from repro_torch.core.fixed_point import true_div
    from repro_torch.kernels.reconstruct import reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct_ref,
                                            shamir_share_batch_ref)
    from repro_torch.kernels.share_gen import share_gen_batch_ref
    n = flats.shape[0]
    # round 0: party p keys its stream with id p
    ids = (torch.arange(n, device=flats.device) if ids is None
           else torch.as_tensor(ids, device=flats.device))
    k0, k1 = philox.derive_key(seed, ids)
    keys = torch.stack([k0, k1], dim=1)
    acc = None
    for lo in range(0, n, chunk):
        x, k = flats[lo:lo + chunk], keys[lo:lo + chunk]
        if scheme == "additive":
            part = share_gen_batch_ref(x, m, k, fp).sum(0) & U32_MASK
            acc = part if acc is None else (acc + part) & U32_MASK
        else:
            part = shamir_share_batch_ref(x, m, k, fp).sum(0) % MERSENNE_P
            acc = part if acc is None else fadd(acc, part)
    out = (reconstruct_ref(acc, 1, fp) if scheme == "additive"
           else shamir_reconstruct_ref(acc, 1, fp))
    return true_div(out, n)


def phase_rounds(flats, ref_mean) -> dict:
    """The n=10,000 two-phase rounds; returns launches per kernel."""
    import torch
    from repro_torch.core import committee, costmodel
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    from repro_torch.kernels import dispatch
    n, s = flats.shape
    m, chunk, seed = 3, 1024, 1
    launches = {}
    for scheme, algebra in (("additive", "ring"), ("shamir", "field")):
        fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra=algebra)
        tr = make_transport("two_phase", n, m=m, seed=seed, fp=fp,
                            scheme=scheme, chunk=chunk, device="cuda")
        dispatch.reset_launches()
        t0 = time.perf_counter()
        com = tr.elect()
        elect_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = tr.aggregate(flats)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        counts = dict(dispatch.launches)

        p = costmodel.CostParams(n=n, e=1, s=s, m=m, b=tr.b)
        rounds = committee.elect(n, m, tr.b, seed).rounds
        st1 = tr.net.stats("phase1")
        p2 = [tr.net.stats(ph) for ph in
              ("phase2_upload", "phase2_exchange", "phase2_broadcast")]
        require(st1.msg_num == rounds * costmodel.phase1_msg_num(p)
                and st1.msg_size == rounds * costmodel.phase1_msg_size(p),
                f"{scheme}: phase 1 counters {st1} differ from Eqs. 3-4")
        require(sum(x.msg_num for x in p2) == costmodel.phase2_msg_num(p)
                and sum(x.msg_size for x in p2)
                == costmodel.phase2_msg_size(p),
                f"{scheme}: phase 2 counters differ from Eqs. 5-6")
        require(mean.shape == (s,) and bool(torch.isfinite(mean).all()),
                f"{scheme}: mean is not finite of shape ({s},)")
        plain = plain_round_mean(flats, scheme, fp, m, seed, chunk)
        require(torch.equal(mean.view(torch.int32), plain.view(torch.int32)),
                f"{scheme}: the round's mean differs from the same round "
                "through the plain versions on the card")
        del plain
        # Each input is rounded to the nearest 1/scale, an error uniform
        # in +-0.5/scale and independent across parties, so the mean's
        # error per element has sigma (1/scale)/sqrt(12 n); the limit,
        # 4 * 0.5/scale/sqrt(n), is 6.9 sigma (plus the float32 rounding
        # of the mean), far inside half a quantum.
        err = float((mean.double() - ref_mean).abs().max())
        tol = (4 * 0.5 / fp.scale / math.sqrt(n)
               + 2.0 ** -23 * float(ref_mean.abs().max()))
        require(err <= tol, f"{scheme}: mean error {err} above {tol}")
        share_k = ("repro_share_gen_batch" if scheme == "additive"
                   else "repro_shamir_share_batch")
        rec_k = ("repro_reconstruct" if scheme == "additive"
                 else "repro_shamir_reconstruct")
        require(counts[share_k] == -(-n // chunk) and counts[rec_k] == 1,
                f"{scheme}: kernel launches {counts}")
        launches[share_k] = counts[share_k]
        launches[rec_k] = counts[rec_k]
        emit({"phase": "round", "scheme": scheme, "n": n, "s": s, "m": m,
              "chunk": chunk, "committee": list(com),
              "election_rounds": rounds, "phase1_wall_s": elect_s,
              "phase2_wall_s": round_s, "mean_max_err": err,
              "mean_tol": tol, "equal_to_plain_round": True,
              "launches": counts,
              "phase1_msg_num": st1.msg_num,
              "phase2_msg_num": sum(x.msg_num for x in p2),
              "phase2_msg_size": sum(x.msg_size for x in p2)})
        del mean
    return launches


def phase_profile(flats) -> None:
    """Device time by kernel over one n=10,000 round per scheme."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    for scheme, algebra in (("additive", "ring"), ("shamir", "field")):
        fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra=algebra)
        tr = make_transport("two_phase", flats.shape[0], m=3, seed=1, fp=fp,
                            scheme=scheme, chunk=1024, device="cuda")
        tr.elect()
        tr.aggregate(flats, round_index=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.aggregate(flats, round_index=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel rows only: an aten op's row repeats the time of the
        # kernels it launched, so summing every row would count it twice
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        require(rows, f"{scheme}: the trace shows no kernel on the card")
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        emit({"phase": "profile", "scheme": scheme, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / wall_ms,
              "top": [{"kernel": k[:90], "ms": t, "calls": c}
                      for k, t, c in rows[:10]]})


def phase_profile_vss(flats) -> None:
    """Device time of one VSS round, split by the transport's ranges:
    commitment generation, member sums and verification."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra="field")
    tr = make_transport("two_phase", flats.shape[0], m=3, seed=1, fp=fp,
                        scheme="shamir", shamir_degree=1, chunk=1024,
                        vss=True, device="cuda")
    tr.elect()
    tr.aggregate(flats, round_index=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.aggregate(flats, round_index=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    labels = ("vss_commit", "vss_member_sums", "vss_verify")
    # a range's host-side row sums the kernels launched inside it; its
    # row on the card is the range's span there, not kernel time
    split = {label: sum(e.device_time_total for e in avg
                        if e.key == label
                        and e.device_type == DeviceType.CPU) / 1e3
             for label in labels}
    span = {label: sum(e.self_device_time_total for e in avg
                       if e.key == label
                       and e.device_type == DeviceType.CUDA) / 1e3
            for label in labels}
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in avg if e.device_type == DeviceType.CUDA
                   and e.key not in labels
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    require(rows, "vss: the trace shows no kernel on the card")
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "scheme": "shamir_vss", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "device_ms_by_range": split, "device_span_ms_by_range": span,
          "top": [{"kernel": k[:90], "ms": t, "calls": c}
                  for k, t, c in rows[:10]]})


def _timed(fn):
    """Host wall seconds of ``fn`` up to a synchronize, and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_vss(flats) -> int:
    """The malicious-secure round on the card: an honest round, then a
    member of each round's committee tampering with flip, wrong_poly and
    replay in turn.  Returns the verify_shares launches."""
    import torch
    from repro_torch.core import committee, costmodel
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.verify_shares import verify_shares
    n, s = flats.shape
    m, deg, seed, chunk, b = 3, 1, 1, 1024, 10
    fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra="field")
    kw = dict(m=m, seed=seed, fp=fp, scheme="shamir", shamir_degree=deg,
              chunk=chunk, device="cuda")
    # the honest means: the non-VSS Shamir rounds of the same seed
    plain = make_transport("two_phase", n, **kw)
    honest = [plain.aggregate(flats, round_index=r) for r in range(4)]
    tr = make_transport("two_phase", n, vss=True, reelect_each_round=True,
                        **kw)
    elect_rounds = []
    dispatch.reset_launches()
    for r, mode in enumerate((None, "flip", "wrong_poly", "replay")):
        want_rounds = committee.elect(
            n, m, b, seed + r, exclude=set(tr.evicted),
            reputation=dict(tr.reputation) or None).rounds
        elect_s, com = _timed(lambda: tr.elect(r))
        elect_rounds.append(want_rounds)
        victim = com[0] if mode else None
        tamper = {victim: mode} if mode else None
        round_s, mean = _timed(lambda: tr.aggregate(
            flats, round_index=r, committee_tamper=tamper))
        require(torch.equal(mean.view(torch.int32),
                            honest[r].view(torch.int32)),
                f"vss round {r} ({mode}): the mean differs from the "
                "honest round of that index")
        out = tr.last_outcome
        require(out.blamed == ({victim} if mode else set()),
                f"vss round {r} ({mode}): blamed {out.blamed}")
        if mode:
            require(victim in tr.evicted,
                    f"vss round {r}: {victim} not evicted")
            nxt = committee.elect(
                n, m, b, seed + r + 1, exclude=set(tr.evicted),
                reputation=dict(tr.reputation) or None,
                device="cuda").committee
            require(victim not in nxt,
                    f"vss round {r}: {victim} re-elected in {nxt}")
        emit({"phase": "vss_round", "round": r, "mode": mode, "n": n,
              "s": s, "m": m, "degree": deg, "committee": list(com),
              "blamed": sorted(out.blamed), "evicted": sorted(tr.evicted),
              "phase1_wall_s": elect_s, "phase2_wall_s": round_s,
              "equal_to_honest_round": True})
    launches = dict(dispatch.launches)
    require(launches["repro_verify_shares"] > 0,
            f"the vss rounds launched no verify_shares: {launches}")
    require(launches["repro_shamir_share_batch"] > 0,
            f"the vss rounds launched no shamir_share_batch: {launches}")
    p = costmodel.CostParams(n=n, e=1, s=s, m=m, b=b)
    p4 = costmodel.CostParams(n=n, e=4, s=s, m=m, b=b)
    st1 = tr.net.stats("phase1")
    require(st1.msg_num == sum(elect_rounds) * costmodel.phase1_msg_num(p)
            and st1.msg_size
            == sum(elect_rounds) * costmodel.phase1_msg_size(p),
            f"vss phase 1 counters {st1} differ from the re-election forms")
    if elect_rounds == [1] * 4:
        require(st1.msg_num == costmodel.phase1_msg_num_reelect(p4),
                "vss phase 1 counters differ from phase1_msg_num_reelect")
    stc = tr.net.stats("phase2_commit")
    require(stc.msg_num == costmodel.phase2_commit_msg_num(p4)
            and stc.msg_size == costmodel.phase2_commit_msg_size(p4, deg),
            f"vss commitment counters {stc} differ from phase2_commit_*")
    # the round's pieces, timed alone on the same inputs: commitment
    # generation (plain PyTorch on the card) and the member-row check
    ids = list(range(n))
    commit_s, agg = _timed(lambda: tr._aggregate_commits(flats, ids, 0, 0,
                                                         s))
    sums_s, sums = _timed(lambda: tr._member_sums(flats, ids, 0, s))
    verify_s, ok = _timed(lambda: verify_shares(sums, agg, (1, 2, 3)))
    require(bool(ok.bool().all()), "the honest member rows do not verify")
    emit({"phase": "vss", "n": n, "s": s, "rounds": 4,
          "elect_rounds": elect_rounds, "launches": launches,
          "phase1_msg_num": st1.msg_num,
          "phase2_commit_msg_num": stc.msg_num,
          "phase2_commit_msg_size": stc.msg_size,
          "commit_wall_s": commit_s, "member_sums_wall_s": sums_s,
          "verify_wall_s": verify_s,
          "verify_ms": cuda_ms(lambda: verify_shares(sums, agg, (1, 2, 3)),
                               20)})
    return launches["repro_verify_shares"]


def phase_audit(flats) -> int:
    """The norm-bound dealer audit on the card.  Returns the
    verify_shares launches."""
    import torch
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    from repro_torch.kernels import dispatch
    n, s = flats.shape
    m, deg, seed, bound_l2 = 3, 1, 1, 8.0
    fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra="field")
    kw = dict(m=m, seed=seed, fp=fp, scheme="shamir", shamir_degree=deg,
              chunk=1024, vss=True, norm_bound=bound_l2, device="cuda")
    poisoners = {17: ("scale", 0), 900: ("sign_flip", 0)}
    tr = make_transport("two_phase", n, dealer_tamper=poisoners, **kw)
    tr.elect(0)
    dispatch.reset_launches()
    round_s, mean = _timed(lambda: tr.aggregate(flats, round_index=0))
    launches = dict(dispatch.launches)
    require(launches["repro_verify_shares"] >= 2,
            f"the audit round launched verify_shares {launches}")
    out = tr.last_outcome
    require(out.blamed_dealers == set(poisoners),
            f"audit blamed {out.blamed_dealers}, poisoned {set(poisoners)}")
    # the mean is the decoded sum of the honest dealers' secrets, so the
    # plain recomputation may share at degree m-1
    honest = [i for i in range(n) if i not in poisoners]
    want = plain_round_mean(flats[honest].contiguous(), "shamir", fp, m,
                            seed, 1024, ids=honest)
    require(torch.equal(mean.view(torch.int32), want.view(torch.int32)),
            "the audited mean differs from the honest dealers' mean through "
            "the plain versions on the card")
    bad = make_transport("two_phase", n, dealer_tamper={5: ("malformed", 0)},
                         **kw)
    bad.elect(0)
    try:
        bad.aggregate(flats, round_index=0)
    except ValueError as e:
        require("dealer share verification failed for parties [5]"
                in str(e), f"malformed dealer: {e}")
    else:
        raise AssertionError("a malformed dealer did not fail the round")
    norms = [float((flats[i].double() * (32.0 if i in poisoners else 1.0))
                   .norm()) for i in (0, *sorted(poisoners))]
    emit({"phase": "audit", "n": n, "s": s, "norm_bound": bound_l2,
          "blamed_dealers": sorted(out.blamed_dealers),
          "phase2_wall_s": round_s, "launches": launches,
          "norms_honest_and_poisoned": norms,
          "equal_to_plain_honest_mean": True, "malformed_raises": True})
    return launches["repro_verify_shares"]


def phase_streaming() -> None:
    import torch
    from repro_torch.fl import make_transport
    n, s = 64, 10_000
    flats = (np.random.RandomState(2).randn(n, s) * 0.5).astype(np.float32)
    for scheme, degree, drop in (("additive", None, ()), ("shamir", 1, 1)):
        means = {}
        for name, device, chunk_elems in (("whole", "cuda", None),
                                          ("stream", "cuda", 2048),
                                          ("cpu", "cpu", None)):
            tr = make_transport("two_phase", n, m=3, seed=3, scheme=scheme,
                                shamir_degree=degree, device=device,
                                chunk_elems=chunk_elems)
            tr.elect()
            dropout = [tr.committee[drop]] if drop else ()
            means[name] = tr.aggregate(torch.from_numpy(flats),
                                       committee_dropout=dropout).cpu()
        for name in ("stream", "cpu"):
            require(torch.equal(means[name].view(torch.int32),
                                means["whole"].view(torch.int32)),
                    f"{scheme}: {name} mean differs from the whole-vector "
                    "mean on the card")
        emit({"phase": "streaming", "scheme": scheme, "n": n, "s": s,
              "chunk_elems": 2048, "committee_dropout": bool(drop),
              "bit_identical": True})


def phase_fedavg() -> None:
    import torch
    from repro_torch.core import committee, costmodel
    from repro_torch.data import fault_detection_party
    from repro_torch.fl import FedAvgConfig, run_fedavg
    from repro_torch.models import simple_nn
    n_parties, epochs, seed = 8, 5, 0
    data = [fault_detection_party(600, seed=seed, party=p)
            for p in range(n_parties + 1)]
    x_test, y_test = data[n_parties]

    def batches(i, e, it):
        x, y = data[i]
        idx = np.random.RandomState(e * 31 + it).choice(len(x), 64)
        return x[idx], y[idx]

    model = simple_nn.SimpleNN(seed=seed, device="cuda")
    t0 = time.perf_counter()
    res = run_fedavg(FedAvgConfig(n_parties=n_parties, epochs=epochs,
                                  seed=seed), model,
                     simple_nn.sgd_step(model, 0.1), batches, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        logits = torch.func.functional_call(
            model, res.params, (torch.from_numpy(x_test).cuda(),))
    pred = logits.argmax(-1).cpu().numpy()
    tp = int(((pred == 1) & (y_test == 1)).sum())
    tn = int(((pred == 0) & (y_test == 0)).sum())
    recall = tp / max(int((y_test == 1).sum()), 1)
    spec = tn / max(int((y_test == 0).sum()), 1)
    balanced = 0.5 * (recall + spec)
    p = costmodel.CostParams(n=n_parties, e=epochs, s=242, m=3, b=10)
    rounds = committee.elect(n_parties, 3, 10, seed).rounds
    require(res.phases["phase1"][0] == rounds * costmodel.phase1_msg_num(p),
            f"fedavg phase 1 counters {res.phases}")
    p2 = sum(res.phases[k][0] for k in
             ("phase2_upload", "phase2_exchange", "phase2_broadcast"))
    require(p2 == costmodel.phase2_msg_num(p),
            f"fedavg phase 2 counters {res.phases}")
    require(all(bool(torch.isfinite(v).all()) for v in res.params.values()),
            "fedavg parameters are not finite")
    require(balanced > 0.5, f"fedavg balanced accuracy {balanced}")
    emit({"phase": "fedavg", "parties": n_parties, "epochs": epochs,
          "balanced_accuracy": balanced, "wall_s": wall,
          "msg_num": res.msg_num, "msg_size": res.msg_size})


def phase_single_kernels() -> dict:
    """The single-party share kernels against their plain versions at the
    train path's largest leaf and at a ragged shape; returns timing
    rows."""
    import torch
    from repro_torch.core.fixed_point import DEFAULT_FIELD, DEFAULT_RING
    from repro_torch.core.field import to_i32
    from repro_torch.kernels.shamir import shamir_share, shamir_share_ref
    from repro_torch.kernels.share_gen import share_gen, share_gen_ref
    m, deg, keys = 3, 2, (0x1234567, 0xABCDEF01)
    rows = {}
    for d, hi_base in ((10_001, 192), (155_582_464, 0)):
        gen = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn(d, device="cuda", generator=gen) * 0.01
        x[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                              0.5 / 65536, 1.5 / 65536])
        quads = -(-d // 4)
        for name, fn, ref, fp, ops in (
                ("share_gen", share_gen, share_gen_ref, DEFAULT_RING,
                 quads * (m - 1) * PHILOX_OPS + d * (m - 1)),
                ("shamir_share", shamir_share, shamir_share_ref,
                 DEFAULT_FIELD,
                 quads * deg * PHILOX_OPS
                 + d * (deg * TO_FIELD_OPS
                        + m * deg * (FIELD_MUL_OPS + FIELD_ADD_OPS)))):
            got = fn(x, m, *keys, fp, hi_base=hi_base)
            want = to_i32(ref(x, m, *keys, fp, hi_base=hi_base))
            same = torch.equal(got, want)
            err = float((got.to(torch.int64) & 0xFFFFFFFF)
                        .sub(want.to(torch.int64) & 0xFFFFFFFF)
                        .abs().max())
            require(same, f"{name}: kernel differs from its plain version "
                          f"at D={d} hi_base={hi_base} (max abs err {err})")
            del got, want
            entry = {"phase": "kernel", "name": name, "d": d, "m": m,
                     "hi_base": hi_base, "equal": True, "max_abs_err": err}
            if d > 10_001:
                b_ms, b_by = bound(4 * d + 4 * m * d, ops)
                entry.update(
                    ms=cuda_ms(lambda: fn(x, m, *keys, fp, hi_base=hi_base),
                               20),
                    plain_ms=cuda_ms(
                        lambda: ref(x, m, *keys, fp, hi_base=hi_base), 3),
                    bound_ms=b_ms, bound_by=b_by)
                rows[name] = entry
            emit(entry)
        del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def plain_spmd_mean(flats, scheme: str, m: int, seed: int,
                    round_index: int):
    """The SPMD mean of the parties' ``flats`` (one tensor per party),
    composed from the plain versions: party ``p`` shares with the party
    keys of ``hi_base = 64·p``, the words are summed in the ring or the
    field, and the sum is decoded as the reference's jitted decode does
    at n parties."""
    from repro_torch.core.field import U32_MASK, fadd
    from repro_torch.core.fixed_point import DEFAULT_FIELD, DEFAULT_RING
    from repro_torch.fl import spmd
    from repro_torch.kernels.reconstruct import reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct_ref,
                                            shamir_share_ref)
    from repro_torch.kernels.share_gen import share_gen_ref
    n = len(flats)
    k0, k1 = spmd.round_keys(seed, round_index)
    additive = scheme == "additive"
    fp = DEFAULT_RING if additive else DEFAULT_FIELD
    acc = None
    for p, flat in enumerate(flats):
        keys = spmd.party_keys(k0, k1, (64 * p) & U32_MASK)
        if additive:
            s = share_gen_ref(flat, m, *keys, fp)
            acc = s if acc is None else (acc + s) & U32_MASK
        else:
            s = shamir_share_ref(flat, m, *keys, fp)
            acc = s if acc is None else fadd(acc, s)
    inv = spmd.decode_inv_scale(fp, n)
    return (reconstruct_ref(acc, 1, fp, inv_scale=inv) if additive
            else shamir_reconstruct_ref(acc, 1, fp, inv_scale=inv))


SPMD_CASES = [("additive", "psum"), ("additive", "reduce_scatter"),
              ("additive", "p2p"), ("additive", "plain"),
              ("shamir", "psum")]
SPMD_D, SPMD_SEED, SPMD_ROUND = 1_000_003, 5, 1


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _spmd_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One party of the spmd phase (a process of its own)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import choose_backend
    backend = choose_backend(world, "cuda")
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {"backend": backend, **_spmd_checks(rank, world)}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spmd_checks(rank: int, world: int) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.data import lm_batch
    from repro_torch.fl import spmd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    flats = torch.from_numpy((np.random.RandomState(7).randn(
        world, SPMD_D) * 0.1).astype(np.float32)).cuda()
    out = {"staged": spmd.host_staged(flats, None), "cases": {}}
    for scheme, mode in SPMD_CASES:
        t0 = time.perf_counter()
        mean = spmd.secure_aggregate(flats[rank], scheme=scheme, m=3,
                                     seed=SPMD_SEED, round_index=SPMD_ROUND,
                                     mode=mode)
        torch.cuda.synchronize()
        entry = {"wall_s": time.perf_counter() - t0, "sha": _sha(mean),
                 "finite": bool(torch.isfinite(mean).all())}
        if mode != "plain":
            want = plain_spmd_mean(list(flats), scheme,
                                   world if mode == "p2p" else 3,
                                   SPMD_SEED, SPMD_ROUND)
            entry["equal_to_plain"] = torch.equal(mean.view(torch.int32),
                                                  want.view(torch.int32))
        out["cases"][f"{scheme}_{mode}"] = entry
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    model = transformer.init(cfg, seed=0, device="cuda")
    opt = adamw_init(model.params())
    step = make_train_step(cfg, device="cuda")
    losses = []
    for i in range(2):
        toks, labels = lm_batch(cfg.vocab, 8, 16, seed=0, party=0, step=i)
        model, opt, loss = step(model, opt, i,
                                {"tokens": toks, "labels": labels})
        losses.append(float(loss))
    leaves = [leaf.detach().reshape(-1) for _, leaf in
              flatten_with_path(model.params())]
    out["train_losses"] = losses
    out["params_sha"] = _sha(torch.cat(leaves))
    return out


def phase_spmd() -> None:
    """Four gloo ranks on the one card; see the module docstring."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    world = 4
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    from repro_torch.kernels import dispatch
    # the ranks' results go to a directory inside the checkout (the
    # kernels' build directory, listed in .gitignore)
    dispatch.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_ROOT) as out_dir:
        t0 = time.perf_counter()
        mp.spawn(_spmd_rank, args=(world, port, out_dir), nprocs=world,
                 join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(world)]
    require(all(r["backend"] == "gloo" for r in ranks),
            f"ranks sharing one card chose {ranks[0]['backend']}")
    require(all(r["staged"] for r in ranks),
            "gloo with CUDA tensors must stage reduce_scatter/all_gather")
    for key in ranks[0]["cases"]:
        entries = [r["cases"][key] for r in ranks]
        require(len({e["sha"] for e in entries}) == 1,
                f"spmd {key}: the ranks' means differ")
        require(all(e["finite"] for e in entries),
                f"spmd {key}: a mean is not finite")
        if not key.endswith("plain"):
            require(all(e["equal_to_plain"] for e in entries),
                    f"spmd {key}: a mean differs from the plain composition")
        emit({"phase": "spmd", "case": key, "ranks": world, "d": SPMD_D,
              "backend": "gloo",
              "collectives": ("all_reduce on the card's tensors; "
                              "reduce_scatter and all_gather staged through "
                              "host memory"),
              "identical_on_every_rank": True,
              "equal_to_plain": None if key.endswith("plain") else True,
              "wall_s_per_rank": [e["wall_s"] for e in entries]})
    require(len({r["params_sha"] for r in ranks}) == 1,
            "spmd train: the ranks' parameters differ after two steps")
    require(all(np.isfinite(r["train_losses"]).all() for r in ranks),
            "spmd train: a loss is not finite")
    emit({"phase": "spmd_train", "ranks": world, "steps": 2,
          "arch": "qwen1.5-0.5b smoke", "losses": ranks[0]["train_losses"],
          "params_identical_on_every_rank": True, "wall_s": wall})


def _profile_step(step_fn, model, opt, step_idx: int, batch) -> dict:
    """One step under ``torch.profiler``: per range of the step its host
    time and its span on the card, the device time by kernel, and the
    wall time under the trace.  (Backward runs on autograd's own thread,
    outside the host-side ``fwd_bwd`` range; the span on the card covers
    it.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = ("fwd_bwd", "secure_aggregate", "adamw_update")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(model, opt, step_idx, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    span = {label: sum(e.self_device_time_total for e in avg
                       if e.key == label
                       and e.device_type == DeviceType.CUDA) / 1e3
            for label in labels}
    host = {label: sum(e.cpu_time_total for e in avg if e.key == label
                       and e.device_type == DeviceType.CPU) / 1e3
            for label in labels}
    # kernel rows only (a range's row on the card is its span)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in avg if e.device_type == DeviceType.CUDA
                      and e.key not in labels
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    require(kernels, "train: the trace shows no kernel on the card")
    busy = sum(k[1] for k in kernels)
    ours = {name: sum(t for k, t, _ in kernels if name in k)
            for name in ("share_gen_kernel", "shamir_share_kernel",
                         "reconstruct_kernel")}
    return {"wall_ms_traced": wall_ms, "host_ms_by_range": host,
            "device_span_ms_by_range": span, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "aggregation_kernels_ms": ours,
            "secure_aggregate_host_share": host["secure_aggregate"] / wall_ms,
            "secure_aggregate_span_share": span["secure_aggregate"] / wall_ms,
            "top": [{"kernel": k[:90], "ms": t, "calls": c}
                    for k, t, c in kernels[:8]]}


def phase_train() -> dict:
    """The federated LM trainer on qwen1.5-0.5b at full size; returns the
    launches of the secure runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.data import lm_batch
    from repro_torch.fl import spmd
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    steps, batch, seq, seed = 4, 8, 128, 0
    vocab = get_config("qwen1.5-0.5b").vocab
    launches = {}
    for protocol, scheme in (("plain", "additive"), ("two_phase", "additive"),
                             ("two_phase", "shamir")):
        check_s = []

        def observe(grads, agg, protocol=protocol, scheme=scheme,
                    check_s=check_s):
            # the step's aggregate against decode(encode(g)) composed
            # from the plain versions on the card, leaf by leaf
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_idx = len(check_s)
            got = dict(flatten_with_path(agg))
            for path, g in flatten_with_path(grads):
                flat = g.detach().reshape(-1).float()
                if protocol == "plain":
                    want = flat / 1
                else:
                    leaf_seed = (seed ^ spmd.leaf_seed_tag(path)) \
                        & 0x7FFFFFFF
                    want = plain_spmd_mean([flat], scheme, 3, leaf_seed,
                                           step_idx)
                require(torch.equal(got[path].reshape(-1).view(torch.int32),
                                    want.view(torch.int32)),
                        f"train {protocol}/{scheme} step {step_idx}: leaf "
                        f"{path} differs from the plain composition")
                del want
            torch.cuda.synchronize()
            check_s.append(time.perf_counter() - t0)

        args = train.parse_args(
            ["--arch", "qwen1.5-0.5b", "--steps", str(steps), "--batch",
             str(batch), "--seq", str(seq), "--protocol", protocol,
             "--scheme", scheme, "--seed", str(seed), "--log-every", "1"])
        torch.cuda.empty_cache()
        dispatch.reset_launches()
        out = train.run(args, observe=observe)
        counts = dict(dispatch.launches)
        require(len(check_s) == steps,
                f"train {protocol}/{scheme}: {len(check_s)} steps checked")
        require(all(math.isfinite(x) for x in out["losses"]),
                f"train {protocol}/{scheme}: losses {out['losses']}")
        share_k, rec_k = (("repro_share_gen", "repro_reconstruct")
                          if scheme == "additive" else
                          ("repro_shamir_share", "repro_shamir_reconstruct"))
        per_step = 0 if protocol == "plain" else 14
        require(counts[share_k] == per_step * steps
                and counts[rec_k] == per_step * steps
                and sum(counts.values()) == 2 * per_step * steps,
                f"train {protocol}/{scheme}: kernel launches {counts}")
        if per_step:
            for k in (share_k, rec_k):
                launches[k] = launches.get(k, 0) + counts[k]
        lines = [{"step": i, "loss": loss,
                  # the step's host wall without the check above
                  "step_wall_s": wall - chk,
                  "tok_per_s": batch * seq / (wall - chk)}
                 for i, (loss, wall, chk) in enumerate(
                     zip(out["losses"], out["step_wall_s"], check_s))]
        # two more steps without the check: one profiled, one timed alone
        # with the peak device memory of a step
        step_fn = out["step_fn"]
        step_fn.observe = None
        model, opt = out["model"], out["opt_state"]
        del out
        batches = [lm_batch(vocab, batch, seq, seed=seed, party=0, step=i)
                   for i in (steps, steps + 1)]
        prof = _profile_step(step_fn, model, opt, steps,
                             dict(zip(("tokens", "labels"), batches[0])))
        torch.cuda.reset_peak_memory_stats()
        wall, (_, _, loss) = _timed(lambda: step_fn(
            model, opt, steps + 1, dict(zip(("tokens", "labels"),
                                            batches[1]))))
        emit({"phase": "train", "arch": "qwen1.5-0.5b", "protocol": protocol,
              "scheme": scheme, "parties": 1, "batch": batch, "seq": seq,
              "steps": lines, "launches": {k: v for k, v in counts.items()
                                           if v},
              "aggregate_equal_to_plain_composition": True,
              "check_wall_s": sum(check_s),
              "unchecked_step": {"step": steps + 1, "loss": float(loss),
                                 "wall_s": wall,
                                 "tok_per_s": batch * seq / wall,
                                 "peak_mem_bytes":
                                     torch.cuda.max_memory_allocated()},
              "profiled_step": prof})
        del model, opt, step_fn
    torch.cuda.empty_cache()
    return launches


KERNELS = [
    ("share_gen_batch", "repro_share_gen_batch",
     "src/repro_torch/kernels/csrc/share_gen.cu",
     "src/repro/kernels/share_gen/kernel.py:140"),
    ("shamir_share_batch", "repro_shamir_share_batch",
     "src/repro_torch/kernels/csrc/shamir.cu",
     "src/repro/kernels/shamir/kernel.py:111"),
    ("reconstruct", "repro_reconstruct",
     "src/repro_torch/kernels/csrc/reconstruct.cu",
     "src/repro/kernels/reconstruct/kernel.py:33"),
    ("shamir_reconstruct", "repro_shamir_reconstruct",
     "src/repro_torch/kernels/csrc/shamir.cu",
     "src/repro/kernels/shamir/kernel.py:158"),
    ("verify_shares", "repro_verify_shares",
     "src/repro_torch/kernels/csrc/verify_shares.cu",
     "src/repro/kernels/verify_shares/kernel.py:43"),
    ("share_gen", "repro_share_gen",
     "src/repro_torch/kernels/csrc/share_gen.cu",
     "src/repro/kernels/share_gen/kernel.py:89"),
    ("shamir_share", "repro_shamir_share",
     "src/repro_torch/kernels/csrc/shamir.cu",
     "src/repro/kernels/shamir/kernel.py:68"),
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one round per scheme and one "
                             "VSS round")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernels()
    verify_rows = phase_verify_kernel()
    # the kernels line reports verify_shares at the audit shape, the
    # largest the main path gives it
    rows["verify_shares"] = verify_rows["audit"]

    n, s = 10_000, 10_000
    flats = torch.from_numpy(
        (np.random.RandomState(0).randn(n, s) * 0.1).astype(np.float32)
    ).cuda()
    ref_mean = flats.double().mean(0)
    launches = phase_rounds(flats, ref_mean)
    if args.profile:
        phase_profile(flats)
    del ref_mean
    vss_flats = flats[:2048].contiguous()
    launches["repro_verify_shares"] = phase_vss(vss_flats)
    if args.profile:
        phase_profile_vss(vss_flats)
    launches["repro_verify_shares"] += phase_audit(
        (flats[:1024] * 0.1).contiguous())
    del flats, vss_flats
    torch.cuda.empty_cache()
    phase_streaming()
    phase_fedavg()
    rows.update(phase_single_kernels())
    phase_spmd()
    # the train path also decodes through the slice-1 reconstructions:
    # their launches are the rounds' and the train steps' together
    for key, count in phase_train().items():
        launches[key] = launches.get(key, 0) + count

    kernels = []
    for name, key, source, replaces in KERNELS:
        row = rows[name]
        require(launches.get(key, 0) > 0,
                f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            # no single PyTorch call computes these functions
            "library_ms": None})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
