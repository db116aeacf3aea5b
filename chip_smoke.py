#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each a hard check (any failure raises, and the script exits
non-zero without the final result line):

1. device: the card's name and power limit as nvidia-smi reports them,
   and the host's CPU model and cores;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
   every instantiation of the attention kernels (flash: float32 on the
   CUDA cores and bf16 on the tensor cores, each at D up to 32, 64, 128,
   256; decode: 11 instantiations of the split kernel, and the fold) and
   of ``lru_scan`` must
   show no stack frame and no spill in ptxas's lines, and the SASS of
   every bf16 flash instantiation (``cuobjdump -sass`` of the built
   library) must hold tensor-core products (HMMA or HGMMA) and
   asynchronous copies (LDGSTS or UTMALDG);
3. attention kernels: ``flash_attention`` against its plain version on
   the same CUDA tensors at qwen1.5-0.5b's prefill shape [8, 16, 2048,
   64] causal (bf16 and float32), a ragged Sq = Skv = 1,000, the GQA
   groups of tinyllama-1.1b (32, 4) and llama3.2-1b (32, 8), a window of
   64, Sq < Skv, D = 128 (float32 and bf16) and D = 32 (bf16), and at
   recurrentgemma-9b's D = 256 with 16 query heads on one KV head (its
   prefill shape [8, 16, 2048, 256] in window 2,048, ragged lengths, a
   binding window of 256), and at the MoE family's prefill shapes,
   qwen3-moe-235b-a22b's q [8, 64, 2048, 128] on 4 KV heads (group 16)
   and grok-1-314b's [8, 48, 2048, 128] on 8 (group 6), causal, in bf16
   and float32, each timed (events and graph replay) beside its bound
   and SDPA's time; and at the enc-dec and dense variants' prefill
   shapes, each timed:
   whisper-large-v3's encoder [8, 20, 1500, 64] non-causal (bf16, checked
   at batch 2; float32 at batch 2), its decoder's causal [8, 20, 448, 64]
   and its cross-attention, 448 queries against 1,500 keys, non-causal
   (bf16; float32 at batch 2), starcoder2-3b's [2, 24, 16384, 128] on 2
   KV heads (group 12) in its window of 4,096 (checked at 1 x 8,192;
   SDPA given the window as a boolean mask), group 12 x D 128 ragged
   (bf16 and float32) and in a binding window of 512, and qwen2-vl-2b's
   [8, 12, 2048, 128] on 2 KV heads; ``decode_attention`` (the split
   kernel and
   its fold: partials and the normalized output) at [8, 16, 64] against
   a cache of S = 640 at kv_len 1 / 7 / 65 / 300 / 640 (bf16 and float32
   queries on a bf16 cache, and a float32 cache), the GQA group (32, 4),
   and group 16 × D 256 against S = 2,048 at kv_len 1 / 9 / 192 / 1,000
   / 2,048 (7 and 9 below one split; 1,000 and the GQA group's 300 end
   in a ragged split; qwen's one-row heads take one split at any
   kv_len), and the MoE serve paths' group 16 × D 128 against S = 160
   at kv_len 1 / 9 / 100 / 160 and group 6 × D 128 against S = 80 at
   kv_len 1 / 33 / 80 (100, 33 and 80 end in a ragged split), both
   against S = 2,048 at kv_len 1,000, and the variants' serve paths:
   whisper's self-attention [8, 20, 64] against S = 128 and its
   cross-attention against the 1,500 encoder keys (one split), group 12
   x D 128 (starcoder2-3b) against S = 192 and against its full window
   S_buf 4,096 at kv_len 1 / 4,096 (a wrapped ring: every slot valid),
   group 6 x D 128 (qwen2-vl-2b) against S = 192; float32 outputs to
   2e-5 absolute + 1e-4 relative, bf16
   outputs to one bf16 step of each value (2^-7 relative) + 2e-5;
   median times from CUDA events beside the bound, the plain version's
   time and SDPA's (timed for the table only; a decode row's time is
   the normalized call's, split kernel and fold together, and SDPA's,
   each from CUDA-graph replays: one call's events would time the
   host's launch); ``lru_scan``
   (the RG-LRU recurrence) at recurrentgemma-9b's prefill shape
   [8, 2048, 4096] in float32 and bf16, a ragged [3, 1000, 1000] and a
   4,096-step carry at a = 0.9999 (also against a float64 scan), each
   ``torch.equal`` to its plain version, with its time (by events and by
   CUDA-graph replay) and bound;
   ``ssm_scan``
   (the Mamba-1 selective scan) at falcon-mamba-7b's prefill shape
   [8, 2048, 8192], st 16 (bf16 and float32), a ragged S = di = 1,000,
   st 4, 4,096 steps with small |A| (the carry, held against a float64
   scan: no farther from it than the plain version) and 1,001 channels
   at st 5 (the element-wise copies), with
   ptxas's registers (16 instantiations, none with a stack frame or a
   spill), the launch plan (blocks, blocks an SM holds, waves), its time
   by CUDA events and by CUDA-graph replay, its bound (bytes, float32
   instructions or exponentials, whichever is largest, at the card's
   clock) and the plain version's time;
4. kernels: each of the four kernels of the two-phase round against its
   plain PyTorch version on the same CUDA tensors at the main-path
   shapes (a party chunk of l=1024, m=3, D=10,000, plus a ragged
   D=10,001 with a non-zero counter offset): ``torch.equal`` on the bit
   patterns, then median times from CUDA events and from CUDA-graph
   replay (device time, the host's launch taken out) beside the bound,
   and one trivial launch (the floor every kernel pays);
   then the Feldman check ``verify_shares`` at the member-row shape
   (k=3, D=10,000), a ragged D=10,001 and the audit shape (k=3,
   D=1,024 x 10,000), each with a known set of tampered elements;
5. rounds: the two-phase round at n=10,000 parties and s=10,000
   elements, additive and Shamir, through ``make_transport`` on the
   card, with counters against Eqs. 3-6, the mean bit for bit against
   the same round through the plain versions on the card, and within
   the fixed-point rounding of the float64 plain mean;
6. vss: the malicious-secure round (Feldman VSS, per-round
   re-election) at n=2,048, s=10,000: an honest round, then a member
   tampering with ``flip``, ``wrong_poly`` and ``replay`` in turn,
   each blamed, evicted and re-elected away with the honest mean;
7. audit: the norm-bound dealer audit at n=1,024, s=10,000 with a
   ``scale`` and a ``sign_flip`` dealer, both blamed, and a
   ``malformed`` dealer that fails the round;
8. topk: top-k compression with error feedback at the main round's size
   (n = 10,000, s = 10,000, m = 3, 1 % kept, Q.10 codec): two rounds of
   each scheme through ``FLSimulation(compression=...)``, then a plain
   round of every party and a P2P round of 16: each mean ``torch.equal``
   to the same rounds composed on the card from a stable sort of each
   row (the lowest index first among equal magnitudes) and the plain
   share and reconstruct versions, each party's residual equal to that
   composition's, sent + kept equal to the carried update, the phase-2
   counters equal to the top-k form of Eq. 6 (P2P's to Eq. 2's), the
   share and reconstruct kernels launched; and a row with 300 magnitudes
   tied at the top-k boundary whose selection on the card is the
   lowest-indexed set;
9. cohort: cohort-sampled rounds through ``FLSimulation(...,
   cohort=1000)`` over a registry of 100,000 parties at s = 10,000, a
   ``FixedPointConfig(frac_bits=15, clip=32.0)`` codec, three rounds per
   scheme, with a seeded 10 % of the registry leaving the eligible pool
   between rounds: each round's cohort equal to ``sample_cohort`` on the
   CPU (and every survivor of the previous pool that ranked in still in
   it), its committee equal to ``elect_among`` on the CPU, its counters
   equal to ``subrounds·2·c·(c−1)`` of b and to
   ``costmodel.phase2_cohort_msg_num/size``, its mean ``torch.equal`` to
   the same round through the plain versions on the card, one launch of
   the scheme's share and reconstruct kernels; the draw's ms, the Phase I
   and Phase II wall seconds and one traced round's device busy share;
10. scenarios: the reference's battery through ``run_scenario`` on the
   card: the eight simulation scenarios (honest, two non-IID splits,
   churn, stragglers, a scaled and a sign-flipped dealer with their
   honest twins, a malformed dealer) and the two wire scenarios
   (``churn_stragglers_wire``, ``poisoned_dealer_wire``: n = 8 party
   worker processes on the card): counters equal to the mirror, every
   poisoned dealer banned, the malformed dealer's round aborted by the
   verify's ``ValueError``, every final accuracy above 0.5, each
   record's wall time;
11. wire: the wire transport (``make_transport(backend="wire")``: a
   coordinator on the host, 8 party worker processes spawned with
   ``--device cuda``, the warm-up barrier on), n = 8, m = 3, s =
   2,500,000 (three chunks of the default 2^20, the last 402,848), two
   rounds each of additive and Shamir under the hub and the tree relay:
   each mean ``torch.equal`` to the same round through the sim transport
   on the card and within the fixed-point bound of the float64 mean,
   every party alive, the counters equal to Eqs. 3-6 and to the sim's
   phase by phase, the coordinator's data bytes equal to
   ``costmodel.coordinator_data_bytes``, and, from the workers' per-round
   log records, one share launch a chunk in every party and one
   reconstruct launch on the final member, on the card; worker start-up,
   warm-up, Phase I and Phase II wall seconds and MB/s through the
   coordinator.  Then a Shamir VSS round trio at s = 10,000 under the
   tree with per-round re-election: a member flips its regional sums in
   round 1 and is blamed, condemned and evicted (that round equal to the
   sim's round without its region, the next to the honest mean), with
   ``verify_shares`` launches in every member's record; and one cohort
   round (registry 8, cohort 6, hub) whose cohort equals
   ``sample_cohort`` on the CPU and whose mean equals the sim's;
12. streaming: chunked aggregation equals the whole vector, and the card
   equals the port's CPU path, bit for bit;
13. FedAvg: ``run_fedavg`` on SimpleNN with 8 parties on the card;
14. single-party kernels: ``share_gen`` and ``shamir_share`` (the SPMD
    path's share kernels) against their plain versions, ``torch.equal``,
    at the train path's largest leaf (D = 155,582,464, m = 3, degree 2)
    and at a ragged D = 10,001 with ``hi_base`` 192, with times and
    bounds; then ``reconstruct`` and ``shamir_reconstruct`` of the
    largest leaf's shares against their plain versions, timed alike;
15. spmd: four ``gloo`` ranks on the one card (ranks share it, so the
    backend rule picks gloo; ``reduce_scatter`` and ``all_gather`` stage
    through host memory): every mode and scheme of
    ``fl.spmd.secure_aggregate``, each rank's mean bit-identical to the
    others and, in the secure modes, to the same aggregation composed
    from the plain versions on the card; then two train steps of the
    smoke config, with identical parameters on every rank;
16. train: the federated LM trainer (``launch.train``) on qwen1.5-0.5b
    at full width and depth, a world of one, global batch 8 x seq 128,
    four steps each of ``plain``, ``two_phase`` additive and
    ``two_phase`` Shamir: every step's aggregated gradient, leaf by leaf,
    bit-identical to decode(encode(g)) composed from the plain versions
    on the card; 14 launches of the scheme's share and reconstruct
    kernels per secure step (and none of the attention kernels); loss,
    step wall time and tok/s per step (the check's time taken out: the
    trainer's own "tok/s" lines count it), then one profiled step split
    into its ``fwd_bwd``, ``secure_aggregate`` and ``adamw_update``
    ranges and one unchecked step with its peak device memory;
17. train_topk: the same trainer with ``--compress-topk 0.01``, three
    steps each of additive and Shamir: every step's aggregate bit for bit
    against decode(encode(densified g)) from the plain versions, 14
    launches of each kernel a step, step wall time and tok/s;
18. fsdp: the trainer's default command (``launch.train --steps 3``:
    tinyllama-1.1b at full size, 22 layers, batch 8 x seq 128) on one
    card as a world of one, which the layout rule sends through
    MPC-FSDP: ``share_gen`` and ``reconstruct`` launched in every step
    (the secure reduce-scatter in backward), one step's parameters bit
    for bit equal to the same step in the replicated layout, step wall,
    tok/s, peak memory and one profiled step's busy share; both kernels
    against their plain versions at the FSDP shapes (a layer's
    ``w_gate``, the embedding), timed; then four ``gloo`` ranks on the
    card at tinyllama-1.1b's width and one layer: each rank's
    aggregated gradient (its shards of the split leaves, taken through
    ``observe``) equal to its slice of the replicated layout's aggregate
    (at most 0.1 % of a leaf's nonzero elements apart, each by at most
    2^-16), and the gathered parameters after the step identical on
    every rank and within 1e-6 of the replicated layout's;
19. ckpt: the smoke config on the card with ``--compress-topk``: two
    steps, a checkpoint, two more resumed from it, bit for bit equal to
    four steps run straight (parameters, moments and residuals);
20. prefill: ``make_prefill`` on qwen1.5-0.5b at full width and depth,
    random weights from seed 0, batch 8 x prompt 2,048 in the config's
    bf16: 24 flash launches per call, wall time and tok/s per call, the
    logits against the same prefill through the plain attention on the
    card (in float32 compute to 1e-3; in bf16 within the distance, as a
    root mean square over the logits, that bf16 compute puts between the
    plain logits and float32's), and one profiled call;
21. serve: the ``launch.serve`` loop (prefill by decode, then greedy
    generation) on qwen1.5-0.5b at full size, batch 8: in float32
    compute over the first 128 prompt tokens and 32 generated, every
    step's logits against the plain step on the card fed the same
    tokens (each with its own bf16 cache) to 1e-2, greedy tokens equal
    except at printed near-ties, and the first generated token's logits
    against the prefill's to 5e-2; then in the config's bf16 at prompt
    512, gen 128, 24 decode launches per step, ms per step, tok/s, peak
    memory and one profiled step's device busy share;
22. ssm_prefill: falcon-mamba-7b at full width and depth (64 layers,
    7.27 B parameters, random weights from seed 0), ``make_prefill`` at
    batch 8 x 2,048 in bf16: 64 launches of the selective-scan kernel a
    call, wall time, tok/s, peak memory and one profiled call; the
    logits against the chunked plain path at batch 2 (float32 compute to
    1e-3; bf16 within the distance, as an RMS, that bf16 compute puts
    between the plain logits and float32's);
23. ssm_serve: the ``launch.serve`` loop on the same model, batch 8,
    prompt 128, gen 64: the first generated token's logits against the
    prefill's in float32 compute (1e-3), then in bf16 ms per step, tok/s,
    peak memory and one profiled step (the SSM step runs no hand-written
    kernel, as the reference's);
24. hybrid_prefill: recurrentgemma-9b at full width and depth (38
    layers, 10,444,984,320 parameters, random weights from seed 0),
    ``make_prefill`` at batch 8 x 2,048 in bf16: 26 ``lru_scan`` and 12
    flash launches a call, wall time, tok/s, peak memory and one
    profiled call; the logits against the plain path (chunked scan,
    plain attention) at batch 2 (float32 compute to 1e-3; bf16 within
    the bf16-vs-float32 RMS);
25. hybrid_serve: the ``launch.serve`` loop on the same model, batch 8,
    prompt 128, gen 64: the first generated token's float32 logits
    against the prefill's with a float32 cache (1e-3) and with the bf16
    cache (5e-2), then in bf16 12 decode launches a step, ms per step,
    tok/s, peak memory and one profiled step;
26. ring: the smoke configs of recurrentgemma-9b and starcoder2-3b
    (window 8) served through the kernels for 24 steps each, so each
    8-slot ring wraps twice, each step's float32 logits against the
    plain step fed the same tokens (1e-4);
27. moe_init, moe_prefill, moe_serve: qwen3-moe-235b-a22b at full width
    (d 4,096, 64 heads on 4 KV heads, 128 experts, top 8, expert FF
    1,536, vocab 151,936), the depth cut from 94 to 4 layers
    (11,195,678,720 parameters, 44.8 GB of float32, random weights from
    seed 0): ``make_prefill`` at batch 8 x 2,048 in bf16 (capacity
    1,280, 131,072 assignments; 4 flash launches a call), the share of
    assignments dropped in each layer, wall, tok/s, peak memory and one
    profiled call; one layer's ``moe_apply`` under CUDA's sync debug
    mode (no wait for the host); at batch 2 the float32 logits against
    the plain path to 1e-3 and the bf16 logits within the
    bf16-vs-float32 RMS, every path run under the float32 kernel path's
    routing (``moe.force_routing``), and the (token, layer) pairs whose
    own routing differs between the kernel and plain paths counted,
    each at a near-tie (float32: the k-th and (k+1)-th router logits
    within 1e-4; bf16: within what its logits moved); then the
    ``launch.serve`` loop at batch 8, prompt 128, gen 32: in float32
    every step's logits against the plain step fed the same tokens under
    the kernel step's routing (1e-2), greedy tokens equal except at
    near-ties; in bf16 4 decode launches a step, ms a step, tok/s, the
    ms a step spends casting the expert stacks to bf16 and one profiled
    step;
28. grok_moe_init, grok_moe_prefill, grok_moe_serve: grok-1-314b at
    full width (d 6,144, 48 heads on 8 KV heads, 8 experts, top 2,
    expert FF 32,768), cut from 64 to 2 layers (11,450,572,800
    parameters, 45.8 GB): the same checks, prefill at 8 x 2,048
    (capacity 5,120), serving at prompt 64, gen 16;
29. hybrid_train: recurrentgemma-9b at full width cut to one (rec, rec,
    attn) group and its 2-layer tail (3,223,478,272 parameters) through
    the trainer's layout rule (MPC-FSDP at one party), 3 steps at batch
    8 x 128 on the chunked scan under autograd: step wall, tok/s, peak
    memory, the share and reconstruct launches a step;
30. encdec_init, encdec_prefill, encdec_serve: whisper-large-v3 at full
    width and depth (32 encoder and 32 decoder layers, d 1,280, 20
    heads, vocab 51,866, random weights from seed 0): ``make_prefill``
    at batch 8 on seeded random frames [8, 1500, 1280] and 448 decoder
    tokens in bf16, 96 flash launches a call (encoder, self- and
    cross-attention), wall, tok/s, frames/s, peak memory, one profiled
    call; at batch 2 the float32 logits against the plain path to 1e-3
    and the bf16 logits within the bf16-vs-float32 RMS; then the
    ``launch.serve`` loop at batch 8, prompt 64, gen 64, from the cross
    K/V of the encoded frames: in float32 every step's logits against
    the plain step fed the same tokens (1e-2), then in bf16 64 decode
    launches a step (self- and cross-attention), ms a step, tok/s and
    one profiled step;
31. vlm_init, vlm_prefill, vlm_serve: qwen2-vl-2b at full width and
    depth (28 layers) fed seeded random embeds: prefill at batch
    8 x 2,048 (28 flash launches a call), the same checks at batch 2;
    serving at batch 8, 128 prompt steps and 64 generated, embeds at
    every step, bf16 timed (28 decode launches a step), after a float32
    check of each step of a 32 + 32-step loop;
32. window_init, window_prefill, window_serve: starcoder2-3b at full
    width and depth (30 layers, layernorm, biased gelu MLP, window
    4,096): prefill at 2 x 16,384 in bf16, where the window binds (30
    flash launches a call), its checks at 1 x 8,192; serving at batch 8,
    prompt 128, gen 64, bf16 timed, after the float32 check of a
    32 + 32-step loop;
33. summary: a ``{"kernels": [...]}`` line (the attention kernels also
    at D = 256, under ``d256``, at the MoE family's shapes, under
    ``moe``, and at whisper-large-v3's, qwen2-vl-2b's and
    starcoder2-3b's, under ``encdec``, ``vlm`` and ``window``, each
    with its own path's launches), then the result line.

Every phase prints one JSON object per line, with the seconds since the
script started (``elapsed_s``).  The script imports no JAX
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
import os
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


#: the script's start, for the seconds each phase's lines report
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
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


def graph_ms(fn, calls: int = 20, reps: int = 20) -> float:
    """Median milliseconds of one call of ``fn`` on the card: CUDA events
    around the replay of a CUDA graph of ``calls`` calls, so the host's
    launch cost (Python, ctypes, the driver) is taken out and the
    device's time, gaps between kernels included, stays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host": host_facts()})
    return smi[0]


def host_facts() -> dict:
    """The host's CPU model and its cores (host times vary with them)."""
    import platform
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                key, _, value = ln.partition(":")
                info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = next((info[k] for k in ("model name", "cpu model", "hardware")
                  if info.get(k)), "") or platform.processor()
    if not model and info.get("cpu family"):
        model = (f"{info.get('vendor_id', '')} family {info['cpu family']} "
                 f"model {info.get('model', '?')}")
    return {"cpu_model": model or "unknown",
            "vendor": info.get("vendor_id", ""),
            "machine": platform.machine(), "cpu_count": os.cpu_count(),
            "cores_usable": len(os.sched_getaffinity(0))}


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
    phase_launch_floor()
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
                             graph_ms=graph_ms(kernel_fn),
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
                         graph_ms=graph_ms(
                             lambda: verify_shares(rows, cm, points)),
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
                     chunk: int, ids=None, round_index: int = 0):
    """A round's mean at full committee, recomputed on the card through
    the plain share and reconstruct versions, party chunk by party chunk,
    with a fold of its own: what the transport's chunk loop, key
    derivation and fold must reproduce bit for bit.  ``ids`` are the
    uploaders' global ids (a cohort's, say; default ``0..n-1``)."""
    import torch
    from repro_torch.core import philox
    from repro_torch.core.field import MERSENNE_P, U32_MASK, fadd
    from repro_torch.core.fixed_point import true_div
    from repro_torch.kernels.reconstruct import reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct_ref,
                                            shamir_share_batch_ref)
    from repro_torch.kernels.share_gen import share_gen_batch_ref
    n = flats.shape[0]
    # party p of round r keys its stream with (r << 24) | p, a 64-bit
    # stream id passed as its (lo, hi) words
    ids = (torch.arange(n, device=flats.device) if ids is None
           else torch.as_tensor(ids, device=flats.device))
    stream_lo = ((round_index << 24) & U32_MASK) | ids
    k0, k1 = philox.derive_key(seed, (stream_lo, (round_index << 24) >> 32))
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


def _trace(fn) -> tuple[float, list]:
    """Host wall ms of one call of ``fn`` up to a synchronize, and the
    kernels a ``torch.profiler`` trace shows on the card: ``(name, ms,
    calls)``, longest first.  Kernel rows only: an aten op's row repeats
    the time of the kernels it launched, so summing every row would
    count it twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    require(rows, "the trace shows no kernel on the card")
    return wall_ms, sorted(rows, key=lambda r: -r[1])


def _busy_share(fn) -> dict:
    """Host wall and device busy time of one traced call of ``fn``."""
    wall_ms, rows = _trace(fn)
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms}


def phase_profile(flats) -> None:
    """Device time by kernel over one n=10,000 round per scheme."""
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import make_transport
    for scheme, algebra in (("additive", "ring"), ("shamir", "field")):
        fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra=algebra)
        tr = make_transport("two_phase", flats.shape[0], m=3, seed=1, fp=fp,
                            scheme=scheme, chunk=1024, device="cuda")
        tr.elect()
        tr.aggregate(flats, round_index=0)
        wall_ms, rows = _trace(lambda: tr.aggregate(flats, round_index=1))
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


#: the cohort acceptance row (DESIGN.md §12): registry, cohort, model
#: size (the n = 10,000 round's s), committee, vote batch, seed, rounds
COHORT_SHAPE = dict(n=100_000, c=1_000, s=10_000, m=3, b=10, seed=0,
                    rounds=3)
#: share of the registry that leaves the eligible pool between rounds
COHORT_DROP = 0.1


def phase_cohort() -> dict:
    """Cohort-sampled rounds on the card: a registry of 100,000 parties,
    a cohort of 1,000 a round, s = 10,000, three rounds per scheme
    through ``FLSimulation(..., cohort=1000)``, with a seeded 10 % of the
    registry leaving the eligible pool between rounds.  Returns the
    launches per kernel."""
    import torch
    from repro_torch.core import committee, costmodel
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import FLSimulation
    from repro_torch.fl.cohort import sample_cohort
    from repro_torch.kernels import dispatch
    n, c, s, m, b, seed, rounds = (COHORT_SHAPE[k] for k in (
        "n", "c", "s", "m", "b", "seed", "rounds"))
    p = costmodel.CostParams(n=n, e=1, s=s, m=m, b=b)
    p2_phases = ("phase2_upload", "phase2_exchange", "phase2_broadcast")
    totals = {}
    for scheme, algebra in (("additive", "ring"), ("shamir", "field")):
        # a 1,000-party sum needs more headroom than the default codec's
        # 511 (ring) and 255 (field) summands: 2,047 and 1,023 here
        fp = FixedPointConfig(frac_bits=15, clip=32.0, algebra=algebra)
        sim = FLSimulation(n, m=m, b=b, seed=seed, scheme=scheme, fp=fp,
                           cohort=c, device="cuda")
        tr = sim.transports["two_phase"]
        drops = np.random.RandomState(seed + 1)
        data = np.random.RandomState(seed + 2)
        pool = set(range(n))
        for r in range(rounds):
            kept = None
            if r:
                prev = pool
                gone = drops.choice(sorted(prev), int(COHORT_DROP * n),
                                    replace=False)
                pool = prev - set(gone.tolist())
                # ranks are per id: whoever ranked into round r's cohort
                # of the previous pool and is still eligible ranks in
                kept = set(sample_cohort(prev, c, seed, r)) & pool
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drawn = sample_cohort(pool, c, seed, r)
            draw_ms = (time.perf_counter() - t0) * 1e3
            want_ids = sample_cohort(pool, c, seed, r, device="cpu")
            require(drawn == want_ids,
                    f"{scheme} round {r}: the cohort drawn on the card "
                    "differs from the one drawn on the CPU")
            flats = torch.from_numpy(
                (data.randn(c, s) * 0.1).astype(np.float32)).cuda()
            before = {k: (v.msg_num, v.msg_size)
                      for k, v in sim.net.phases.items()}
            dispatch.reset_launches()
            phase1_s, com = _timed(lambda: sim.elect_committee(
                eligible=pool))
            ids = tr.cohort_ids
            phase2_s, (mean, _) = _timed(lambda: sim.aggregate(
                "two_phase", flats, party_ids=ids))
            counts = dict(dispatch.launches)
            require(ids == want_ids, f"{scheme} round {r}: cohort {ids[:5]}"
                    f"... differs from sample_cohort on the CPU")
            lost = sorted((kept or set()) - set(ids))
            require(not lost, f"{scheme} round {r}: survivors {lost} of "
                    "the previous pool lost their rank")
            ref = committee.elect_among(ids, m, b, seed + r, device="cpu")
            require(tuple(com) == ref.committee,
                    f"{scheme} round {r}: committee {com} differs from "
                    f"elect_among on the CPU {ref.committee}")

            def delta(ph):
                st = sim.net.stats(ph)
                was = before.get(ph, (0, 0))
                return st.msg_num - was[0], st.msg_size - was[1]
            ph1 = delta("phase1")
            ph2 = [delta(ph) for ph in p2_phases]
            want1 = ref.rounds * 2 * c * (c - 1)
            require(ph1 == (want1, want1 * b),
                    f"{scheme} round {r}: phase 1 counters {ph1}, Eqs. 3-4 "
                    f"per cohort give {(want1, want1 * b)}")
            require(sum(x[0] for x in ph2)
                    == costmodel.phase2_cohort_msg_num(p, c)
                    and sum(x[1] for x in ph2)
                    == costmodel.phase2_cohort_msg_size(p, c),
                    f"{scheme} round {r}: phase 2 counters {ph2} differ "
                    "from costmodel.phase2_cohort_msg_num/size")
            require(mean.shape == (s,) and bool(torch.isfinite(mean).all()),
                    f"{scheme} round {r}: mean is not finite of shape "
                    f"({s},)")
            plain = plain_round_mean(flats, scheme, fp, m, seed, tr.chunk,
                                     ids=list(ids), round_index=r)
            require(torch.equal(mean.view(torch.int32),
                                plain.view(torch.int32)),
                    f"{scheme} round {r}: the cohort's mean differs from "
                    "the same round through the plain versions on the card")
            # the fixed-point rounding of c inputs, as in phase_rounds
            ref_mean = flats.double().mean(0)
            err = float((mean.double() - ref_mean).abs().max())
            tol = (4 * 0.5 / fp.scale / math.sqrt(c)
                   + 2.0 ** -23 * float(ref_mean.abs().max()))
            require(err <= tol, f"{scheme} round {r}: mean error {err} "
                    f"above {tol}")
            share_k = ("repro_share_gen_batch" if scheme == "additive"
                       else "repro_shamir_share_batch")
            rec_k = ("repro_reconstruct" if scheme == "additive"
                     else "repro_shamir_reconstruct")
            require(counts[share_k] == 1 and counts[rec_k] == 1,
                    f"{scheme} round {r}: kernel launches {counts}")
            for key in (share_k, rec_k):
                totals[key] = totals.get(key, 0) + counts[key]
            emit({"phase": "cohort", "scheme": scheme, "round": r,
                  "registry": n, "eligible": len(pool), "cohort": c, "s": s,
                  "m": m, "committee": list(com),
                  "election_subrounds": ref.rounds, "draw_ms": draw_ms,
                  "phase1_wall_s": phase1_s, "phase2_wall_s": phase2_s,
                  "phase1_msg_num": ph1[0],
                  "phase2_msg_num": sum(x[0] for x in ph2),
                  "phase2_msg_size": sum(x[1] for x in ph2),
                  "survivors_kept_rank": None if kept is None else len(kept),
                  "mean_max_err": err, "mean_tol": tol,
                  "equal_to_plain_round": True, "launches": counts})
            del flats, mean, plain, ref_mean
        # one more round, traced: the device's busy share of a whole
        # cohort round (election and aggregation)
        flats = torch.from_numpy(
            (data.randn(c, s) * 0.1).astype(np.float32)).cuda()

        def one_round():
            sim.elect_committee(eligible=pool)
            sim.aggregate("two_phase", flats, party_ids=tr.cohort_ids)
        emit({"phase": "profile", "scheme": f"{scheme}_cohort",
              "registry": n, "cohort": c, "s": s, **_busy_share(one_round)})
        del flats
    torch.cuda.empty_cache()
    return totals


def scenario_battery():
    """The reference's battery (``benchmarks/scenarios.py``) at its own
    parameters: the eight simulation scenarios, then the two wire
    scenarios (n = 8 party worker processes on the card)."""
    from repro_torch.fl.scenarios import (ChurnConfig, DealerConfig,
                                          ScenarioConfig, StragglerConfig)
    # straggler seed 7 puts party 3, the one party outside the seed-0
    # committee (0, 1, 2), over the 0.6 s deadline every round
    straggler = StragglerConfig(deadline_s=0.6, median_s=0.3, sigma=1.2,
                                seed=7)
    return (
        ScenarioConfig(name="honest_iid", epochs=4),
        ScenarioConfig(name="noniid_alpha05", alpha=0.5, epochs=4),
        ScenarioConfig(name="noniid_alpha01", alpha=0.1, epochs=4),
        ScenarioConfig(name="churn_elastic", epochs=5,
                       churn=ChurnConfig(seed=3)),
        ScenarioConfig(name="stragglers_lognormal", epochs=4,
                       straggler=straggler),
        ScenarioConfig(name="poisoned_dealer_scale", epochs=4,
                       norm_bound=8.0, honest_twin=True,
                       dealers=(DealerConfig(party=3, mode="scale",
                                             round_index=1),)),
        ScenarioConfig(name="poisoned_dealer_signflip", epochs=4,
                       norm_bound=8.0, honest_twin=True,
                       dealers=(DealerConfig(party=3, mode="sign_flip",
                                             round_index=1),)),
        ScenarioConfig(name="malformed_dealer", epochs=3, norm_bound=8.0,
                       expect_abort=True,
                       dealers=(DealerConfig(party=2, mode="malformed",
                                             round_index=1),)),
        ScenarioConfig(name="churn_stragglers_wire", backend="wire", n=8,
                       epochs=3, churn=ChurnConfig(seed=3),
                       straggler=straggler),
        ScenarioConfig(name="poisoned_dealer_wire", backend="wire", n=8,
                       epochs=3, norm_bound=8.0,
                       dealers=(DealerConfig(party=3, mode="scale",
                                             round_index=1),)),
    )


def phase_scenarios() -> dict:
    """The adversarial scenario battery through ``run_scenario`` on the
    card (the port's seeded init).  Returns the launches per kernel: the
    main process's, and a wire scenario's workers' from their logs."""
    import dataclasses
    import tempfile
    from repro_torch.fl.scenarios import run_scenario
    from repro_torch.kernels import dispatch
    launches: dict[str, int] = {}

    def add(key, count):
        launches[key] = launches.get(key, 0) + count

    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_ROOT) as root:
        for scn in scenario_battery():
            log_dir = None
            if scn.backend == "wire":
                log_dir = str(Path(root) / scn.name)
                scn = dataclasses.replace(scn, wire_kwargs={
                    **(scn.wire_kwargs or {}), "log_dir": log_dir})
            dispatch.reset_launches()
            t0 = time.perf_counter()
            try:
                rec = run_scenario(scn, device="cuda")
            except BaseException:
                if log_dir is not None:
                    _dump_worker_logs(log_dir)
                raise
            # the record's wall_s is run_fedavg's rounds; run_s adds the
            # set-up (the wire's worker spawns)
            run_s = time.perf_counter() - t0
            for key, count in dispatch.launches.items():
                add(key, count)
            if scn.expect_abort:
                require(rec["aborted"] and rec["error"].startswith(
                    "ValueError: dealer share verification failed"),
                    f"{scn.name}: expected the verify's ValueError, got "
                    f"{rec['error']!r}")
            else:
                require(rec["counters_match"],
                        f"{scn.name}: counters {rec['counters']} differ "
                        f"from the mirror {rec['counters_expected']}")
                require(rec["final_accuracy"] > 0.5,
                        f"{scn.name}: final accuracy "
                        f"{rec['final_accuracy']}")
            if scn.dealers and not scn.expect_abort:
                require(rec["banned"] == [3], f"{scn.name}: banned "
                        f"{rec['banned']}, the poisoned dealer is 3")
            if scn.honest_twin:
                require(rec.get("honest_accuracy", 0.0) > 0.5,
                        f"{scn.name}: the honest twin did not run or "
                        f"scored {rec.get('honest_accuracy')}")
            row = {"phase": "scenario", "name": rec["name"],
                   "wall_s": rec["wall_s"], "run_s": run_s,
                   "final_accuracy": rec.get("final_accuracy"),
                   "final_loss": rec.get("final_loss"),
                   "honest_accuracy": rec.get("honest_accuracy"),
                   "banned": rec.get("banned"), "aborted": rec["aborted"],
                   "error": rec["error"],
                   "counters_match": rec.get("counters_match")}
            if log_dir is not None:
                row.update(_check_wire_scenario(scn, rec, log_dir, add))
            emit(row)
    return {k: v for k, v in launches.items() if v}


def _check_wire_scenario(scn, rec: dict, log_dir: str, add) -> dict:
    """A wire scenario against the same scenario through the simulation
    on the card (the wire is bit-identical to it, so a worker that died
    and was dropped shows as a different loss), and against its workers'
    records: every party's record of every round on the card, one share
    launch a chunk in every party of the round and none elsewhere, one
    reconstruct launch a round."""
    import dataclasses
    from repro_torch.fl.scenarios import run_scenario
    sim = run_scenario(dataclasses.replace(scn, backend="sim",
                                           wire_kwargs=None), device="cuda")
    for key in ("outcomes", "banned", "final_loss", "final_accuracy",
                "counters"):
        require(rec[key] == sim[key], f"{scn.name}: {key} {rec[key]} on "
                 f"the wire, {sim[key]} in the simulation on the card")
    records = _worker_records(log_dir, scn.n)
    chunks = -(-rec["model_elems"] // (1 << 20))
    share_k, rec_k = SHARE_KEYS[scn.scheme], RECONSTRUCT_KEYS[scn.scheme]
    live_rounds = []
    for r, out in enumerate(rec["outcomes"]):
        # a blamed party was live in its round: blame takes it out after
        live = (set(out["alive"]) | set(out["blamed"])
                | set(out["blamed_dealers"]))
        shares = _wire_launches(records, range(scn.n), r, share_k)
        require(shares == {p: chunks if p in live else 0
                           for p in range(scn.n)},
                f"{scn.name} round {r}: share launches {shares}, {chunks} "
                f"in each of {sorted(live)} expected")
        recs = _wire_launches(records, range(scn.n), r, rec_k)
        require(sum(recs.values()) == 1,
                f"{scn.name} round {r}: reconstruct launches {recs}")
        add(share_k, sum(shares.values()))
        add(rec_k, sum(recs.values()))
        live_rounds.append(sorted(live))
    return {"equal_to_sim": True, "live_parties": live_rounds,
            "worker_share_launches": sum(
                len(p) for p in live_rounds) * chunks}


#: the wire phase's plain rounds: 8 party processes on the one card,
#: m = 3, b = 10, s = 2,500,000, so the default chunk of 2^20 elements
#: gives three chunks, the last a ragged 402,848
WIRE_SHAPE = dict(n=8, m=3, b=10, s=2_500_000, seed=0, rounds=2)
WIRE_CASES = [("additive", "hub"), ("additive", "tree"),
              ("shamir", "hub"), ("shamir", "tree")]
#: the VSS round (tree relay, per-round re-election, a flip tamperer in
#: round 1) and the cohort round (registry 8, cohort 6, hub)
WIRE_VSS_S = 10_000
#: at seed 1 round 1's committee (0, 2, 3) has a non-final member, 0,
#: whose region ([0, 5, 6]) holds no other member: a condemned region
#: that held one would take that member's data out and leave the round
#: below its threshold (the reference's quorum rule)
WIRE_VSS_SEED = 1
WIRE_COHORT = 6
SHARE_KEYS = {"additive": "repro_share_gen_batch",
              "shamir": "repro_shamir_share_batch"}
RECONSTRUCT_KEYS = {"additive": "repro_reconstruct",
                    "shamir": "repro_shamir_reconstruct"}


def _worker_records(log_dir: str, n: int) -> dict:
    """``{(party, round): record}`` from the workers' per-round JSON
    lines (``repro_torch.net.party`` writes one to its log a round)."""
    out = {}
    for pid in range(n):
        path = Path(log_dir) / f"party-{pid}.log"
        for line in path.read_text().splitlines() if path.exists() else ():
            if line.startswith("{"):
                rec = json.loads(line)
                out[(rec["party"], rec["round"])] = rec
    return out


def _dump_worker_logs(log_dir: str) -> None:
    """The tail of every worker log, for a wire phase that failed."""
    for path in sorted(Path(log_dir).glob("party-*")):
        lines = path.read_text(errors="replace").splitlines()[-15:]
        print(f"--- {path.name}", *lines, sep="\n", file=sys.stderr)


def _wire_launches(records: dict, parties, rnd: int, kind: str) -> dict:
    """Per-party launches of kernel ``kind`` in round ``rnd``, every
    record on the card."""
    import torch
    card = torch.cuda.get_device_name(0)
    got = {}
    for pid in parties:
        rec = records.get((pid, rnd))
        require(rec is not None, f"party {pid} wrote no record of round "
                f"{rnd}")
        require(rec["device"] == card,
                f"party {pid} ran on {rec['device']!r}, not the card")
        got[pid] = rec["launches"].get(kind, 0)
    return got


def _wire_round_bytes(p, tr, relay: str, committee, rounds: int):
    """The coordinator's data bytes (in, out) after ``rounds`` honest
    rounds of one election: each round's closed form (under the tree,
    at that round's region sizes), the election's votes counted once."""
    from repro_torch.core import costmodel
    from repro_torch.fl.cohort import assign_home
    sub = tr.coordinator.election_rounds
    votes = (sub * 2 * p.n * (p.n - 1)
             * costmodel.message_wire_bytes(p.b, tr.cfg.chunk_elems))
    total = [votes, votes]
    for r in range(rounds):
        sizes = None
        if relay == "tree":
            home = assign_home(range(p.n), committee, tr.cfg.seed, r,
                               device="cpu")
            sizes = [sum(1 for h in home.values() if h == w)
                     for w in committee]
        one = costmodel.coordinator_data_bytes(
            p, relay=relay, subrounds=sub, chunk_elems=tr.cfg.chunk_elems,
            region_sizes=sizes)
        total = [t + x - votes for t, x in zip(total, one)]
    return tuple(total)


def phase_wire() -> dict:
    """The wire transport on the card: a coordinator on the host and one
    party worker process per party, spawned with ``--device cuda``.
    Returns the workers' launches per kernel (from their logs)."""
    import tempfile
    import torch
    from repro_torch.core import costmodel
    from repro_torch.fl import make_transport
    from repro_torch.fl.faults import RoundOutcome
    from repro_torch.kernels import dispatch
    w = WIRE_SHAPE
    n, m, b, s, seed, rounds = (w["n"], w["m"], w["b"], w["s"], w["seed"],
                                w["rounds"])
    chunks = -(-s // (1 << 20))
    flats = torch.from_numpy(
        (np.random.RandomState(5).randn(n, s) * 0.1).astype(np.float32))
    ref_mean = flats.double().mean(0)
    flats_card = flats.cuda()
    launches: dict[str, int] = {}

    def add(key, count):
        launches[key] = launches.get(key, 0) + count

    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_ROOT) as root:
        log_dir = root
        try:
            for scheme, relay in WIRE_CASES:
                log_dir = str(Path(root) / f"{scheme}-{relay}")
                sim = make_transport("two_phase", n, m=m, b=b, seed=seed,
                                     scheme=scheme, device="cuda")
                sim.elect()
                with make_transport(
                        "two_phase", n, backend="wire", m=m, b=b,
                        seed=seed, scheme=scheme, relay=relay,
                        warmup=True, device="cuda",
                        log_dir=log_dir) as tr:
                    rows, means = [], []
                    com = tr.elect()
                    require(com == sim.committee,
                            f"wire committee {com} vs sim {sim.committee}")
                    for r in range(rounds):
                        bytes0 = (tr.coordinator.data_bytes_in
                                  + tr.coordinator.data_bytes_out)
                        mean = tr.aggregate(flats, round_index=r)
                        torch.cuda.synchronize()
                        want = sim.aggregate(flats_card, round_index=r)
                        require(mean.is_cuda and torch.equal(
                            mean.view(torch.int32), want.view(torch.int32)),
                            f"wire {scheme}/{relay} round {r}: mean differs "
                            "from the sim's on the card")
                        means.append(mean)
                        fp = tr.cfg.fp()
                        err = float((mean.double().cpu() - ref_mean)
                                    .abs().max())
                        tol = (4 * 0.5 / fp.scale / math.sqrt(n)
                               + 2.0 ** -23 * float(ref_mean.abs().max()))
                        require(err <= tol, f"wire {scheme}/{relay}: mean "
                                f"error {err} above {tol}")
                        require(tr.last_outcome == RoundOutcome(
                            alive=set(range(n)), dropped=set(),
                            straggled=set()),
                            f"wire {scheme}/{relay} round {r}: outcome "
                            f"{tr.last_outcome}")
                        p = costmodel.CostParams(n=n, e=r + 1, s=s, m=m,
                                                 b=b)
                        sub = tr.coordinator.election_rounds
                        st1 = tr.net.stats("phase1")
                        require((st1.msg_num, st1.msg_size) == (
                            sub * costmodel.phase1_msg_num(p),
                            sub * costmodel.phase1_msg_size(p)),
                            f"wire {scheme}/{relay}: phase 1 {st1}")
                        p2 = [tr.net.stats(ph) for ph in
                              ("phase2_upload", "phase2_exchange",
                               "phase2_broadcast")]
                        require((sum(x.msg_num for x in p2),
                                 sum(x.msg_size for x in p2)) == (
                            costmodel.phase2_msg_num(p),
                            costmodel.phase2_msg_size(p)),
                            f"wire {scheme}/{relay}: phase 2 counters")
                        for ph in ("phase1", "phase2_upload",
                                   "phase2_exchange", "phase2_broadcast"):
                            require(tr.net.stats(ph) == sim.net.stats(ph),
                                    f"wire {scheme}/{relay}: {ph} "
                                    f"{tr.net.stats(ph)} vs the sim's "
                                    f"{sim.net.stats(ph)}")
                        co = tr.coordinator
                        want_bytes = _wire_round_bytes(p, tr, relay, com,
                                                       r + 1)
                        require((co.data_bytes_in, co.data_bytes_out)
                                == want_bytes,
                                f"wire {scheme}/{relay}: coordinator bytes "
                                f"{(co.data_bytes_in, co.data_bytes_out)} "
                                f"vs {want_bytes}")
                        t2 = co.stage_times[("phase2", r)]
                        tw = co.stage_times.get(("warmup", r), (0.0, 0.0))
                        wall = (t2[1] - t2[0]) - (tw[1] - tw[0])
                        moved = (co.data_bytes_in + co.data_bytes_out
                                 - bytes0)
                        t1 = co.stage_times[("phase1", 0)]
                        rows.append({"phase": "wire", "scheme": scheme,
                              "relay": relay, "n": n, "m": m, "s": s,
                              "round": r, "chunks": chunks,
                              "committee": list(com),
                              "startup_s": tr.startup_s,
                              "phase1_wall_s": t1[1] - t1[0],
                              "warmup_s": tw[1] - tw[0],
                              "phase2_wall_s": wall,
                              "coordinator_mb": moved / 1e6,
                              "coordinator_mb_per_s": moved / 1e6 / wall,
                              "data_bytes_in": co.data_bytes_in,
                              "data_bytes_out": co.data_bytes_out,
                              "mean_max_err": err, "mean_tol": tol,
                              "equal_to_sim": True})
                # a worker writes its round's record after the broadcast,
                # so the records are read once the workers have exited
                records = _worker_records(log_dir, n)
                for row in rows:
                    r = row["round"]
                    shares = _wire_launches(records, range(n), r,
                                            SHARE_KEYS[scheme])
                    recs = _wire_launches(records, range(n), r,
                                          RECONSTRUCT_KEYS[scheme])
                    require(set(shares.values()) == {chunks},
                            f"wire {scheme}/{relay}: share launches "
                            f"{shares}, {chunks} a party expected")
                    require(recs == {pid: int(pid == com[-1])
                                     for pid in range(n)},
                            f"wire {scheme}/{relay}: reconstruct "
                            f"launches {recs}, one on {com[-1]}")
                    add(SHARE_KEYS[scheme], sum(shares.values()))
                    add(RECONSTRUCT_KEYS[scheme], sum(recs.values()))
                    # the slowest worker's host seconds a step: INPUT
                    # received, shares made and copied to the host, the
                    # upload sent, the member's duties, the whole round
                    steps = {k: max(records[(pid, r)].get(k, 0.0)
                                    for pid in range(n))
                             for k in ("input_s", "share_s", "upload_s",
                                       "member_s", "round_s")}
                    emit({**row, "share_launches": shares,
                          "reconstruct_launches": recs,
                          "worker_max_s": steps})
                if relay == "hub":
                    # the tree gives the kernels the same shapes
                    _wire_kernel_checks(sim.agg, flats_card, means, seed)
                del sim, means
            log_dir = str(Path(root) / "vss")
            _phase_wire_vss(log_dir, flats[:, :WIRE_VSS_S].contiguous(),
                            add)
            log_dir = str(Path(root) / "cohort")
            _phase_wire_cohort(log_dir, flats, flats_card)
        except BaseException:
            _dump_worker_logs(log_dir)
            raise
    del flats_card
    torch.cuda.empty_cache()
    return launches


def _wire_kernel_checks(agg, flats_card, means, seed: int) -> None:
    """The share and reconstruct kernels at the wire's own shapes, held
    bit for bit against their plain versions on the same inputs: every
    party's chunks ``[1, 2^20]`` (the last the ragged tail) at their
    counter offsets with every round's keys, as the workers call them,
    then the final member's reconstruction of the member sums
    ``[m, s]``, whose decoded mean must be the wire round's."""
    import torch
    from repro_torch.core.field import MERSENNE_P, U32_MASK, to_i32
    from repro_torch.kernels.reconstruct import reconstruct, reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct,
                                            shamir_reconstruct_ref,
                                            shamir_share_batch,
                                            shamir_share_batch_ref)
    from repro_torch.kernels.share_gen import (share_gen_batch,
                                               share_gen_batch_ref)
    n, s = flats_card.shape
    chunk, m, fp = 1 << 20, agg.m, agg.fp
    additive = agg.scheme == "additive"
    tails = []
    for r, mean in enumerate(means):
        sums = torch.zeros(m, s, dtype=torch.int64, device="cuda")
        for pid in range(n):
            keys64 = agg.party_key_words(seed, [pid], r)
            keys = to_i32(keys64).contiguous()
            for e_lo in range(0, s, chunk):
                x = flats_card[pid:pid + 1, e_lo:e_lo + chunk]
                if additive:
                    got = share_gen_batch(x, m, keys, fp, e_lo // 4)
                    want = share_gen_batch_ref(x, m, keys64, fp, e_lo // 4)
                else:
                    got = shamir_share_batch(x, m, keys, fp,
                                             agg.shamir_degree, e_lo // 4)
                    want = shamir_share_batch_ref(
                        x, m, keys64, fp, agg.shamir_degree, e_lo // 4)
                require(torch.equal(_bits(got), to_i32(want)),
                        f"wire shapes: {agg.scheme} shares of party {pid} "
                        f"round {r} at elem_base {e_lo} differ from the "
                        "plain version")
                sums[:, e_lo:e_lo + x.shape[1]] += want[0] & U32_MASK
                if r == 0 and pid == 0:
                    tails.append(int(x.shape[1]))
        words = to_i32(sums & U32_MASK if additive else sums % MERSENNE_P)
        if additive:
            got, want = (reconstruct(words, 1, fp),
                         reconstruct_ref(words, 1, fp))
        else:
            got, want = (shamir_reconstruct(words, 1, fp),
                         shamir_reconstruct_ref(words, 1, fp))
        require(torch.equal(_bits(got), _bits(want)),
                f"wire shapes: {agg.scheme} reconstruction of round {r} "
                "differs from the plain version")
        require(torch.equal(_bits(agg.reconstruct_mean(words, n)),
                            _bits(mean)),
                f"wire shapes: {agg.scheme} round {r}: the mean of the "
                "checked shares is not the wire round's")
        del sums, words
    emit({"phase": "wire_kernels", "scheme": agg.scheme, "parties": n,
          "rounds": len(means), "chunks": tails, "s": s, "m": m,
          "equal": True, "max_abs_err": 0, "mean_equal_to_wire": True})


def _phase_wire_vss(log_dir: str, flats, add) -> None:
    """Shamir VSS at degree 1 under the tree relay with per-round
    re-election: round 0 honest; in round 1 a non-final member whose
    region holds no other member flips its outgoing regional sums, every
    receiver's
    check blames it, the quorum condemns it, its region's dealers leave
    the round (the sim's round without them and with the member dropped,
    bit for bit); round 2 re-elects without it and equals the honest
    mean."""
    import torch
    from repro_torch.core import committee as committee_mod
    from repro_torch.fl import make_transport
    from repro_torch.fl.cohort import assign_home
    n, m, b = (WIRE_SHAPE[k] for k in ("n", "m", "b"))
    seed = WIRE_VSS_SEED
    kw = dict(m=m, b=b, seed=seed, scheme="shamir", shamir_degree=1,
              vss=True, reelect_each_round=True)
    com1 = committee_mod.elect(n, m, b, seed + 1, device="cpu").committee
    home = assign_home(range(n), com1, seed, 1, device="cpu")
    regions = {w: sorted(p for p, h in home.items() if h == w)
               for w in com1}
    victim = next((w for w in com1[:-1] if regions[w]
                   and not set(regions[w]) & (set(com1) - {w})), None)
    require(victim is not None, f"no member of {com1} has a region "
            f"{regions} free of the other members")
    region = regions[victim]
    survivors = [p for p in range(n) if p not in region]
    card = flats.cuda()
    honest = make_transport("two_phase", n, device="cuda", **kw)
    honest_means = [honest.aggregate(card, round_index=r) for r in range(3)]
    sim = make_transport("two_phase", n, device="cuda", **kw)
    sim.aggregate(card, round_index=0)
    degraded = sim.aggregate(card[survivors], party_ids=survivors,
                             round_index=1, committee_dropout=[victim])
    with make_transport(
            "two_phase", n, backend="wire", relay="tree", warmup=True,
            device="cuda", log_dir=log_dir,
            party_extra_args={victim: ["--tamper", "flip",
                                       "--tamper-round", "1"]},
            **kw) as tr:
        for r, want in enumerate((honest_means[0], degraded,
                                  honest_means[2])):
            mean = tr.aggregate(flats, round_index=r)
            require(torch.equal(mean.view(torch.int32),
                                want.view(torch.int32)),
                    f"wire vss round {r}: mean differs from the sim's")
            if r == 1:
                out = tr.last_outcome
                blamed = sorted(out.blamed)
                require(out.blamed == {victim}
                        and out.dropped == set(region) - {victim}
                        and out.alive == set(survivors)
                        and tr.evicted == {victim},
                        f"wire vss: outcome {out}, evicted {tr.evicted}, "
                        f"victim {victim}, region {region}")
            if r == 2:
                require(victim not in tr.committee,
                        f"wire vss: {victim} re-elected into "
                        f"{tr.committee}")
        evicted = sorted(tr.evicted)
        committee2 = list(tr.committee)
    records = _worker_records(log_dir, n)
    verify = {}
    for r in range(3):
        got = _wire_launches(records, range(n), r,
                             "repro_verify_shares")
        verify[r] = got
        add("repro_verify_shares", sum(got.values()))
        add("repro_shamir_share_batch", sum(_wire_launches(
            records, range(n), r, "repro_shamir_share_batch").values()))
        add("repro_shamir_reconstruct", sum(_wire_launches(
            records, range(n), r, "repro_shamir_reconstruct").values()))
    require(all(verify[1][w] > 0 for w in com1),
            f"wire vss: verify_shares launches {verify[1]} in round 1")
    emit({"phase": "wire_vss", "n": n, "s": int(flats.shape[1]),
          "relay": "tree", "degree": 1, "victim": victim,
          "region": region, "blamed": blamed,
          "evicted": evicted, "committee_round2": committee2,
          "verify_launches": {str(r): v for r, v in verify.items()},
          "means_equal_to_sim": True})


def _phase_wire_cohort(log_dir: str, flats, flats_card) -> None:
    """One cohort round, registry 8, cohort 6, hub: the cohort equals
    ``sample_cohort`` on the CPU and the mean the sim's on the card."""
    import torch
    from repro_torch.fl import make_transport
    from repro_torch.fl.cohort import sample_cohort
    n, m, b, seed = (WIRE_SHAPE[k] for k in ("n", "m", "b", "seed"))
    sim = make_transport("two_phase", n, m=m, b=b, seed=seed,
                         cohort=WIRE_COHORT, device="cuda")
    sim.elect(0)
    cids = list(sim.cohort_ids)
    want = sim.aggregate(flats_card[cids], party_ids=cids, round_index=0)
    with make_transport("two_phase", n, backend="wire", m=m, b=b,
                        seed=seed, cohort=WIRE_COHORT, warmup=True,
                        device="cuda", log_dir=log_dir) as tr:
        tr.elect(0)
        drawn = sample_cohort(range(n), WIRE_COHORT, seed, 0, device="cpu")
        require(tr.cohort_ids == drawn == tuple(cids),
                f"wire cohort {tr.cohort_ids} vs sample_cohort {drawn}")
        mean = tr.aggregate(flats[cids], party_ids=cids, round_index=0)
        require(torch.equal(mean.view(torch.int32), want.view(torch.int32)),
                "wire cohort round: mean differs from the sim's")
        require(tr.last_outcome.alive == set(cids)
                and not tr.last_outcome.dropped,
                f"wire cohort round: outcome {tr.last_outcome}")
        emit({"phase": "wire_cohort", "registry": n, "cohort": cids,
              "committee": list(tr.committee), "equal_to_sim": True})


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


def phase_launch_floor() -> None:
    """One launch of a trivial kernel (PyTorch's fill of one float32
    element) inside a CUDA graph, and by one call's events: the floor of
    device time every kernel pays a launch."""
    import torch
    one = torch.empty(1, device="cuda")
    emit({"phase": "kernel", "name": "launch_floor",
          "op": "zero_ of one float32 element",
          "graph_ms": graph_ms(one.zero_, 100, 20),
          "ms": cuda_ms(one.zero_, 50)})


def _large_reconstructions(x, m: int, deg: int, keys) -> None:
    """``reconstruct`` and ``shamir_reconstruct`` at the train step's
    largest leaf: one party's m shares of ``x`` summed back, each against
    its plain version (``torch.equal``), timed by events and by CUDA-graph
    replay beside the bound."""
    import torch
    from repro_torch.core.fixed_point import DEFAULT_FIELD, DEFAULT_RING
    from repro_torch.kernels.reconstruct import reconstruct, reconstruct_ref
    from repro_torch.kernels.shamir import (shamir_reconstruct,
                                            shamir_reconstruct_ref,
                                            shamir_share)
    from repro_torch.kernels.share_gen import share_gen
    d = x.shape[0]
    for name, fn, ref, fp, shares, nbytes, ops in (
            ("reconstruct", reconstruct, reconstruct_ref, DEFAULT_RING,
             share_gen(x, m, *keys, DEFAULT_RING),
             4 * m * d + 4 * d, (m - 1) * d),
            ("shamir_reconstruct", shamir_reconstruct,
             shamir_reconstruct_ref, DEFAULT_FIELD,
             shamir_share(x, m, *keys, DEFAULT_FIELD, deg),
             4 * m * d + 4 * m + 4 * d,
             d * (m * FIELD_MUL_OPS + (m - 1) * FIELD_ADD_OPS))):
        got, want = fn(shares, 1, fp), ref(shares, 1, fp)
        require(torch.equal(_bits(got), _bits(want)),
                f"{name} differs from its plain version at D={d}")
        del got, want
        b_ms, b_by = bound(nbytes, ops)
        emit({"phase": "kernel", "name": name, "d": d, "m": m,
              "equal": True, "max_abs_err": 0.0,
              "ms": cuda_ms(lambda: fn(shares, 1, fp), 20),
              "graph_ms": graph_ms(lambda: fn(shares, 1, fp), 5, 10),
              "plain_ms": cuda_ms(lambda: ref(shares, 1, fp), 3),
              "bound_ms": b_ms, "bound_by": b_by})
        del shares
    torch.cuda.empty_cache()


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
                    graph_ms=graph_ms(
                        lambda: fn(x, m, *keys, fp, hi_base=hi_base), 5, 10),
                    plain_ms=cuda_ms(
                        lambda: ref(x, m, *keys, fp, hi_base=hi_base), 3),
                    bound_ms=b_ms, bound_by=b_by)
                rows[name] = entry
            emit(entry)
        if d > 10_001:
            _large_reconstructions(x, m, deg, keys)
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


def _aggregate_check(what: str, protocol: str, scheme: str, seed: int,
                     check_s: list):
    """A ``TrainStep.observe`` that holds each step's aggregate against
    decode(encode(g)) composed from the plain versions on the card, leaf
    by leaf (``g`` the party's gradient as the step shares it: densified
    under top-k); appends each check's seconds to ``check_s``."""
    import torch
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.fl import spmd

    def observe(grads, agg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_idx = len(check_s)
        got = dict(flatten_with_path(agg))
        for path, g in flatten_with_path(grads):
            flat = g.detach().reshape(-1).float()
            if protocol == "plain":
                want = flat / 1
            else:
                leaf_seed = (seed ^ spmd.leaf_seed_tag(path)) & 0x7FFFFFFF
                want = plain_spmd_mean([flat], scheme, 3, leaf_seed,
                                       step_idx)
            require(torch.equal(got[path].reshape(-1).view(torch.int32),
                                want.view(torch.int32)),
                    f"{what} step {step_idx}: leaf {path} differs from the "
                    "plain composition")
            del want
        torch.cuda.synchronize()
        check_s.append(time.perf_counter() - t0)
    return observe


def phase_train() -> dict:
    """The federated LM trainer on qwen1.5-0.5b at full size; returns the
    launches of the secure runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    steps, batch, seq, seed = 4, 8, 128, 0
    vocab = get_config("qwen1.5-0.5b").vocab
    launches = {}
    for protocol, scheme in (("plain", "additive"), ("two_phase", "additive"),
                             ("two_phase", "shamir")):
        check_s = []
        observe = _aggregate_check(f"train {protocol}/{scheme}", protocol,
                                   scheme, seed, check_s)
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


#: the top-k rounds: the main round's size, 1 % of the coordinates kept
TOPK_SHAPE = dict(n=10_000, s=10_000, m=3, ratio=0.01, rounds=2, seed=1,
                  chunk=1024, p2p_parties=16)


def _plain_topk(carried, k: int):
    """Top-k of each row composed another way than the transport's: a
    stable descending sort of the magnitudes (the lowest index first
    among equals, as ``jax.lax.top_k``), the first k scattered onto
    zeros.  Returns (sent, kept)."""
    import torch
    idx = torch.sort(carried.abs(), dim=1, descending=True,
                     stable=True).indices[:, :k]
    sent = torch.zeros_like(carried).scatter_add_(1, idx,
                                                  carried.gather(1, idx))
    return sent, carried.scatter(1, idx, 0.0)


def _topk_rows(n: int, s: int, rounds: int):
    """Each round's updates on the card: Gaussian draws on a grid of
    1/64, so magnitudes tie at the top-k boundary."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(21)
    return [(torch.randn((n, s), device="cuda", generator=gen) * 6.4)
            .round() / 64 for _ in range(rounds)]


def _topk_tie_row() -> None:
    """A row whose k-th magnitude is shared by many entries: the card's
    selection must be the lowest-indexed set, as a stable sort on the
    host picks it."""
    import torch
    from repro_torch.core.compression import (CompressionConfig,
                                              compress_topk_batch)
    s, k = 10_000, 100
    row = np.full(s, 0.01, np.float32)
    rng = np.random.RandomState(5)
    row[rng.choice(s, 60, replace=False)] = 1.0      # above the boundary
    ties = rng.choice(np.flatnonzero(row < 1), 300, replace=False)
    row[ties] = np.where(rng.rand(300) < 0.5, 0.5, -0.5)  # the k-th value
    cfg = CompressionConfig(enabled=True, top_k_ratio=k / s)
    dense, kept = compress_topk_batch(torch.from_numpy(row)[None].cuda(),
                                      cfg, torch.zeros((1, s), device="cuda"))
    want = np.sort(np.argsort(-np.abs(row), kind="stable")[:k])
    got = np.flatnonzero(dense[0].cpu().numpy())
    require(np.array_equal(got, want),
            "topk: the card's selection at a tied boundary is not the "
            "lowest-indexed set")
    require(torch.equal(dense + kept, torch.from_numpy(row)[None].cuda()),
            "topk: sent + kept differs from the row")


def phase_topk() -> dict:
    """Top-k rounds at n = 10,000, s = 10,000; returns the launches."""
    import torch
    from repro_torch.core import costmodel
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.fl import FLSimulation
    from repro_torch.kernels import dispatch
    sh = TOPK_SHAPE
    n, s, m, seed, chunk = sh["n"], sh["s"], sh["m"], sh["seed"], sh["chunk"]
    k = max(1, int(s * sh["ratio"]))
    cfg = CompressionConfig(enabled=True, top_k_ratio=sh["ratio"])
    rows = _topk_rows(n, s, sh["rounds"])
    _topk_tie_row()
    launches: dict = {}
    for scheme, algebra in (("additive", "ring"), ("shamir", "field")):
        fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra=algebra)
        sim = FLSimulation(n, m=m, seed=seed, fp=fp, scheme=scheme,
                           chunk=chunk, compression=cfg, device="cuda")
        kept = torch.zeros((n, s), device="cuda")
        walls, counts = [], {}
        for r, x in enumerate(rows):
            dispatch.reset_launches()
            wall, (mean, _) = _timed(lambda: sim.aggregate("two_phase", x))
            walls.append(wall)
            for key, c in dispatch.launches.items():
                counts[key] = counts.get(key, 0) + c
            carried = x + kept
            sent, kept = _plain_topk(carried, k)
            require(torch.equal(sent + kept, carried),
                    f"topk {scheme} round {r}: sent + kept != carried")
            want = plain_round_mean(sent, scheme, fp, m, seed, chunk,
                                    round_index=r)
            require(torch.equal(mean.view(torch.int32),
                                want.view(torch.int32)),
                    f"topk {scheme} round {r}: the mean differs from the "
                    "plain composition")
            del carried, sent, want, mean
        tr = sim.transports["two_phase"]
        require(torch.equal(tr.error_states(range(n)), kept),
                f"topk {scheme}: the residuals differ from the plain "
                "composition's")
        p = costmodel.CostParams(n=n, e=sh["rounds"], s=s, m=m)
        p2 = sum(sim.net.stats(ph).msg_size for ph in (
            "phase2_upload", "phase2_exchange", "phase2_broadcast"))
        require(p2 == costmodel.phase2_msg_size_topk(p, sh["ratio"]),
                f"topk {scheme}: phase 2 counters {p2} differ from the "
                "top-k form of Eq. 6")
        share_k = ("repro_share_gen_batch" if scheme == "additive"
                   else "repro_shamir_share_batch")
        rec_k = ("repro_reconstruct" if scheme == "additive"
                 else "repro_shamir_reconstruct")
        require(counts.get(share_k, 0) == sh["rounds"] * -(-n // chunk)
                and counts.get(rec_k, 0) == sh["rounds"],
                f"topk {scheme}: kernel launches {counts}")
        for key in (share_k, rec_k):
            launches[key] = launches.get(key, 0) + counts[key]
        entry = {"phase": "topk", "scheme": scheme, "n": n, "s": s, "m": m,
                 "ratio": sh["ratio"], "k": k, "rounds": sh["rounds"],
                 "phase2_wall_s": walls, "phase2_msg_size": p2,
                 "phase2_msg_size_dense": costmodel.phase2_msg_size(p),
                 "launches": {key: c for key, c in counts.items() if c},
                 "equal_to_plain_round": True, "residuals_equal": True}
        if scheme == "additive":
            # the baselines over the same transports' network: one plain
            # round of every party and one P2P round of the first few
            # (P2P shares to every other party: m = l)
            l = sh["p2p_parties"]
            for protocol, x, ids in (("plain", rows[0], None),
                                     ("p2p", rows[1][:l], list(range(l)))):
                tr_b = sim.transports[protocol]
                r = sim.round
                mean, _ = sim.aggregate(protocol, x, party_ids=ids)
                sent, kept_b = _plain_topk(x, k)
                want = (sent.mean(dim=0) if protocol == "plain"
                        else plain_round_mean(sent, "additive", fp, l, seed,
                                              chunk, ids=ids,
                                              round_index=r))
                require(torch.equal(mean.view(torch.int32),
                                    want.view(torch.int32)),
                        f"topk {protocol}: the mean differs from the plain "
                        "composition")
                require(torch.equal(tr_b.error_states(
                    ids if ids is not None else range(n)), kept_b),
                        f"topk {protocol}: the residuals differ")
            q = costmodel.CostParams(n=l, e=1, s=s, m=m)
            require(sim.net.stats("p2p").msg_size
                    == costmodel.p2p_msg_size_topk(q, sh["ratio"]),
                    "topk p2p: counters differ from the top-k form of Eq. 2")
            entry["baselines_equal_to_plain"] = ["plain", f"p2p l={l}"]
        emit(entry)
        del sim, kept
        torch.cuda.empty_cache()
    del rows
    torch.cuda.empty_cache()
    return launches


def phase_train_topk() -> dict:
    """The trainer on qwen1.5-0.5b at full size with ``--compress-topk
    0.01``, additive and Shamir; returns the launches."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    steps, batch, seq, seed = 3, 8, 128, 0
    launches: dict = {}
    for scheme in ("additive", "shamir"):
        check_s: list = []
        observe = _aggregate_check(f"train_topk {scheme}", "two_phase",
                                   scheme, seed, check_s)
        args = train.parse_args(
            ["--arch", "qwen1.5-0.5b", "--steps", str(steps), "--batch",
             str(batch), "--seq", str(seq), "--scheme", scheme, "--seed",
             str(seed), "--log-every", "1", "--compress-topk", "0.01"])
        torch.cuda.empty_cache()
        dispatch.reset_launches()
        out = train.run(args, observe=observe)
        counts = dict(dispatch.launches)
        require(len(check_s) == steps and all(
            math.isfinite(x) for x in out["losses"]),
            f"train_topk {scheme}: {len(check_s)} steps checked, losses "
            f"{out['losses']}")
        share_k, rec_k = (("repro_share_gen", "repro_reconstruct")
                          if scheme == "additive" else
                          ("repro_shamir_share", "repro_shamir_reconstruct"))
        require(counts[share_k] == 14 * steps and counts[rec_k] == 14 * steps,
                f"train_topk {scheme}: kernel launches {counts}")
        for key in (share_k, rec_k):
            launches[key] = launches.get(key, 0) + counts[key]
        ef = out["opt_state"]["ef"]
        from repro_torch.core.tree import leaves
        kept = sum(int(torch.count_nonzero(e)) for e in leaves(ef))
        emit({"phase": "train_topk", "arch": "qwen1.5-0.5b", "scheme": scheme,
              "ratio": 0.01, "parties": 1, "batch": batch, "seq": seq,
              "losses": out["losses"],
              "step_wall_s": [w - c for w, c in zip(out["step_wall_s"],
                                                    check_s)],
              "tok_per_s": [batch * seq / (w - c) for w, c in
                            zip(out["step_wall_s"], check_s)],
              "check_wall_s": sum(check_s), "residual_nonzero": kept,
              "launches": {k: v for k, v in counts.items() if v},
              "aggregate_equal_to_plain_composition": True})
        del out, ef
    torch.cuda.empty_cache()
    return launches


#: MPC-FSDP at one card: the trainer's default command (tinyllama-1.1b,
#: batch 8 x seq 128), and four ranks at its width with FSDP_RANK_LAYERS
FSDP_STEPS, FSDP_RANK_LAYERS, FSDP_WORLD = 3, 1, 4
#: four parties: each rank's aggregated gradient shards against the
#: matching slice of the replicated layout's aggregate.  Both decode the
#: same ring sums, so equal bits are expected; a leaf may differ in at
#: most FSDP_AGG_MISMATCH of its nonzero elements, each by at most one
#: quantum of the encoding (a gradient an ulp apart can round to the
#: next step of the grid)
FSDP_AGG_MISMATCH, FSDP_AGG_TOL = 1e-3, 2.0 ** -16
#: the gathered parameters after one step against the replicated
#: layout's (tests/test_torch_fsdp.py holds the same on four CPU ranks)
FSDP_LAYOUT_TOL = 1e-6


def _fsdp_kernel_rows() -> list:
    """``share_gen`` and ``reconstruct`` at the FSDP step's shapes: one
    layer's ``w_gate`` of tinyllama-1.1b and its embedding, each against
    its plain version, timed."""
    import torch
    from repro_torch.core.fixed_point import DEFAULT_RING
    from repro_torch.kernels.reconstruct import reconstruct, reconstruct_ref
    from repro_torch.kernels.share_gen import share_gen, share_gen_ref
    m, keys, rows = 3, (0x2468ACE, 0x13579BDF), []
    for name, d in (("w_gate", 2048 * 5632), ("embed", 32000 * 2048)):
        gen = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn(d, device="cuda", generator=gen) * 0.01
        shares = share_gen(x, m, *keys, DEFAULT_RING)
        require(torch.equal(_bits(shares), _bits(share_gen_ref(
            x, m, *keys, DEFAULT_RING))), f"fsdp share_gen at {name}")
        require(torch.equal(_bits(reconstruct(shares, 1, DEFAULT_RING)),
                            _bits(reconstruct_ref(shares, 1, DEFAULT_RING))),
                f"fsdp reconstruct at {name}")
        quads = -(-d // 4)
        for kernel, fn, ref, nbytes, ops in (
                ("share_gen", lambda: share_gen(x, m, *keys, DEFAULT_RING),
                 lambda: share_gen_ref(x, m, *keys, DEFAULT_RING),
                 4 * d + 4 * m * d,
                 quads * (m - 1) * PHILOX_OPS + d * (m - 1)),
                ("reconstruct", lambda: reconstruct(shares, 1, DEFAULT_RING),
                 lambda: reconstruct_ref(shares, 1, DEFAULT_RING),
                 4 * m * d + 4 * d, (m - 1) * d)):
            b_ms, b_by = bound(nbytes, ops)
            row = {"phase": "kernel", "name": kernel, "shape": name, "d": d,
                   "m": m, "equal": True, "max_abs_err": 0.0,
                   "ms": cuda_ms(fn, 10), "graph_ms": graph_ms(fn, 5, 10),
                   "plain_ms": cuda_ms(ref, 2), "bound_ms": b_ms,
                   "bound_by": b_by}
            emit(row)
            rows.append(row)
        del x, shares
    torch.cuda.empty_cache()
    return rows


def _fsdp_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One party of the four-rank FSDP check (a process of its own)."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, path_str
    from repro_torch.data import lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                                  n_layers=FSDP_RANK_LAYERS)
        toks, labels = lm_batch(cfg.vocab, 8, 128, seed=0, party=0, step=0)
        full, aggs = {}, {}
        out = {"rank": rank}
        for layout in ("fsdp", "replicated"):
            step = make_train_step(cfg, fsdp=layout == "fsdp", device="cuda")
            step.observe = lambda grads, agg, layout=layout: aggs.update(
                {layout: {p: x.detach().clone()
                          for p, x in flatten_with_path(agg)}})
            model = transformer.init(cfg, seed=0, device="cuda")
            if step.fsdp:
                dims = step.dims
                model = step.shard_model(model)
            opt = adamw_init(model.params())
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, 0,
                                    {"tokens": toks, "labels": labels})
            torch.cuda.synchronize()
            out[f"{layout}_wall_s"] = time.perf_counter() - t0
            out[f"{layout}_loss"] = float(loss)
            full[layout] = [leaf.detach() for _, leaf in flatten_with_path(
                step.full_params(model.params()))]
            del model, opt
        out["params_sha"] = _sha(torch.cat([x.reshape(-1)
                                            for x in full["fsdp"]]))
        out["max_abs_diff_vs_replicated"] = max(
            float((a - b).abs().max()) for a, b in zip(full["fsdp"],
                                                       full["replicated"]))
        # this rank's aggregate (its shards of the split leaves, whole
        # the others) against its slice of the replicated aggregate
        out["agg"] = []
        for p, got in aggs["fsdp"].items():
            want = aggs["replicated"][p]
            if dims[p] is not None:
                want = want.chunk(world, dims[p])[rank].contiguous()
            out["agg"].append({
                "leaf": path_str(p), "split": dims[p] is not None,
                "shape": list(got.shape), "nonzero": int(
                    torch.count_nonzero(want)),
                "unequal": int((got.view(torch.int32)
                                != want.view(torch.int32)).sum()),
                "max_abs_diff": float((got - want).abs().max())})
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _fsdp_ranks() -> None:
    import socket
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels import dispatch
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dispatch.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_ROOT) as out_dir:
        t0 = time.perf_counter()
        mp.spawn(_fsdp_rank, args=(FSDP_WORLD, port, out_dir),
                 nprocs=FSDP_WORLD, join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(FSDP_WORLD)]
    for r in ranks:
        for leaf in r["agg"]:
            require(leaf["max_abs_diff"] <= FSDP_AGG_TOL
                    and leaf["unequal"] <= FSDP_AGG_MISMATCH
                    * leaf["nonzero"]
                    and (leaf["nonzero"] > 0 or not leaf["split"]),
                    f"fsdp ranks: rank {r['rank']}'s aggregate of "
                    f"{leaf['leaf']} is not its slice of the replicated "
                    f"layout's: {leaf}")
    require(len({r["params_sha"] for r in ranks}) == 1,
            "fsdp ranks: the gathered parameters differ between ranks")
    diff = max(r["max_abs_diff_vs_replicated"] for r in ranks)
    require(diff <= FSDP_LAYOUT_TOL,
            f"fsdp ranks: FSDP parameters {diff} from the replicated "
            f"layout's, above {FSDP_LAYOUT_TOL}")
    emit({"phase": "fsdp_ranks", "ranks": FSDP_WORLD, "backend": "gloo",
          "arch": f"tinyllama-1.1b width, {FSDP_RANK_LAYERS} layer(s)",
          "batch": 8, "seq": 128, "params_identical_on_every_rank": True,
          "max_abs_diff_vs_replicated": diff, "tol": FSDP_LAYOUT_TOL,
          "agg_vs_replicated_slice": {
              "leaves": len(ranks[0]["agg"]),
              "split_leaves": sum(x["split"] for x in ranks[0]["agg"]),
              "unequal": [sum(x["unequal"] for x in r["agg"])
                          for r in ranks],
              "nonzero": [sum(x["nonzero"] for x in r["agg"])
                          for r in ranks],
              "max_abs_diff": max(x["max_abs_diff"] for r in ranks
                                  for x in r["agg"]),
              "tol": FSDP_AGG_TOL, "mismatch_share": FSDP_AGG_MISMATCH},
          "losses": {k: ranks[0][k] for k in ("fsdp_loss",
                                              "replicated_loss")},
          "step_wall_s": {k: [r[k] for r in ranks]
                          for k in ("fsdp_wall_s", "replicated_wall_s")},
          "wall_s": wall})


def phase_fsdp() -> dict:
    """The trainer's default command (tinyllama-1.1b through MPC-FSDP) on
    one card, its step against the replicated step, then four ranks;
    returns the launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.data import lm_batch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    cfg = get_config("tinyllama-1.1b")
    batch, seq = 8, 128
    # one step through each layout from the same weights: at one party
    # both compute decode(encode(g)), so the parameters are the same bits
    toks, labels = lm_batch(cfg.vocab, batch, seq, seed=0, party=0, step=0)
    after = {}
    for fsdp in (True, False):
        step = make_train_step(cfg, fsdp=fsdp, device="cuda")
        model = transformer.init(cfg, seed=0, device="cuda")
        if fsdp:
            model = step.shard_model(model)
        opt = adamw_init(model.params())
        step(model, opt, 0, {"tokens": toks, "labels": labels})
        after[fsdp] = [leaf.detach() for _, leaf in
                       flatten_with_path(model.params())]
        del model, opt
    require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(after[True], after[False])),
            "fsdp: one step's parameters differ from the replicated step's")
    del after
    torch.cuda.empty_cache()

    per_step: list = []

    def observe(grads, agg):
        per_step.append(dict(dispatch.launches))
        dispatch.reset_launches()

    args = train.parse_args(["--steps", str(FSDP_STEPS), "--log-every", "1"])
    require(args.arch == "tinyllama-1.1b" and (args.batch, args.seq)
            == (batch, seq), "fsdp: the trainer's defaults changed")
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    out = train.run(args, observe=observe)
    step_fn = out["step_fn"]
    require(step_fn.fsdp, "fsdp: the default command did not pick MPC-FSDP")
    require(len(per_step) == FSDP_STEPS and all(
        c["repro_share_gen"] > 0 and c["repro_reconstruct"] > 0
        for c in per_step), f"fsdp: launches per step {per_step}")
    require(all(math.isfinite(x) for x in out["losses"]),
            f"fsdp: losses {out['losses']}")
    peak = torch.cuda.max_memory_allocated()
    step_fn.observe = None
    model, opt = out["model"], out["opt_state"]
    prof = _profile_step(step_fn, model, opt, FSDP_STEPS, dict(zip(
        ("tokens", "labels"), lm_batch(cfg.vocab, batch, seq, seed=0,
                                       party=0, step=FSDP_STEPS))))
    split = sum(d is not None for d in step_fn.dims.values())
    emit({"phase": "fsdp", "arch": cfg.name, "layout": "mpc_fsdp",
          "parties": 1, "batch": batch, "seq": seq,
          "params": cfg.param_count(), "split_leaves": split,
          "whole_leaves": len(step_fn.dims) - split,
          "losses": out["losses"], "step_wall_s": out["step_wall_s"],
          "tok_per_s": [batch * seq / w for w in out["step_wall_s"]],
          "launches_per_step": [{k: v for k, v in c.items() if v}
                                for c in per_step],
          "equal_to_replicated_step": True, "peak_mem_bytes": peak,
          "profiled_step": prof})
    launches = {k: sum(c[k] for c in per_step)
                for k in ("repro_share_gen", "repro_reconstruct")}
    del out, model, opt, step_fn
    torch.cuda.empty_cache()
    _fsdp_kernel_rows()
    _fsdp_ranks()
    return launches


def phase_ckpt() -> None:
    """Checkpoint and resume at smoke size on the card: 2 steps, save,
    then 2 more from the checkpoint, bit-identical to 4 steps run
    straight, the top-k residuals included."""
    import tempfile
    import torch
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    base = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "8", "--seq",
            "64", "--compress-topk", "0.05", "--log-every", "1"]
    straight = train.run(train.parse_args(base + ["--steps", "4"]))
    dispatch.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_ROOT) as ck:
        first = train.run(train.parse_args(base + ["--steps", "2",
                                                   "--ckpt-dir", ck]))
        resumed = train.run(train.parse_args(base + ["--steps", "4",
                                                     "--ckpt-dir", ck]))
        saved = sorted(os.listdir(ck))
    require(resumed["start"] == 2, f"ckpt: resumed at {resumed['start']}")
    require(first["losses"] + resumed["losses"] == straight["losses"],
            "ckpt: the resumed losses differ from the straight run's")
    for what in ("params", "opt"):
        trees = [r["model"].params() if what == "params" else r["opt_state"]
                 for r in (resumed, straight)]
        pairs = zip(flatten_with_path(trees[0]), flatten_with_path(trees[1]))
        require(all(pa == pb and torch.equal(a.detach(), b.detach())
                    for (pa, a), (pb, b) in pairs),
                f"ckpt: the resumed {what} differ from the straight run's")
    emit({"phase": "ckpt", "arch": "qwen1.5-0.5b smoke", "steps": 4,
          "resumed_at": 2, "saved": saved, "bit_identical": True,
          "with": ["params", "m", "v", "ef"]})


#: bf16 dense tensor-core peak of an H100 SXM (NVIDIA data sheet): the
#: attention kernels' operation bound
BF16_FLOP_PER_S = 989e12
#: attention tolerances (float32 output; bfloat16 output)
F32_ATOL, F32_RTOL, BF16_ATOL = 2e-5, 1e-4, 2e-2
#: the flash kernel's bfloat16 output against its plain version: both
#: round a float32 result to bf16 at nearest, so they may part by one bf16
#: step of the value (at most 2^-7 of it), plus the float32 limit where the
#: value is near 0
BF16_STEP_RTOL = 2.0 ** -7


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through: the work of a kernel
    that skips what it cannot see."""
    qa = np.arange(sq) + (skv - sq if causal else 0)
    hi = np.minimum(skv - 1, qa) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qa - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def _close(got, want, atol: float, rtol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``; raises past
    ``atol + rtol·|want|``."""
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    require(ok and bool(torch.isfinite(got).all()),
            f"{what}: kernel differs from its plain version "
            f"(max abs err {err})")
    return err


FLASH_CASES = [
    # (name, b, hq, hkv, sq, skv, d, causal, window, dtype); "prefill" is
    # qwen1.5-0.5b's prefill at batch 8 x 2,048, "rg_prefill"
    # recurrentgemma-9b's (MQA, group 16, D 256, window 2,048): the main
    # paths' shapes, both timed
    ("prefill", 8, 16, 16, 2048, 2048, 64, True, 0, "bfloat16"),
    ("rg_prefill", 8, 16, 1, 2048, 2048, 256, True, 2048, "bfloat16"),
    ("rg_prefill_f32", 2, 16, 1, 2048, 2048, 256, True, 2048, "float32"),
    ("rg_ragged", 2, 16, 1, 1000, 1000, 256, True, 0, "float32"),
    ("rg_ragged_bf16", 2, 16, 1, 1000, 1000, 256, True, 0, "bfloat16"),
    # the window binds: query i sees keys i - 255 .. i
    ("rg_window256", 2, 16, 1, 1024, 1024, 256, True, 256, "float32"),
    ("rg_window256_bf16", 2, 16, 1, 1024, 1024, 256, True, 256,
     "bfloat16"),
    ("prefill_f32", 8, 16, 16, 2048, 2048, 64, True, 0, "float32"),
    ("ragged", 2, 16, 16, 1000, 1000, 64, True, 0, "float32"),
    ("ragged_bf16", 2, 16, 16, 1000, 1000, 64, True, 0, "bfloat16"),
    ("gqa_tinyllama", 2, 32, 4, 512, 512, 64, True, 0, "float32"),
    ("gqa_llama32", 2, 32, 8, 512, 512, 64, True, 0, "bfloat16"),
    ("window64", 2, 16, 16, 1000, 1000, 64, True, 64, "float32"),
    ("sq_below_skv", 2, 16, 16, 100, 700, 64, True, 0, "float32"),
    ("d128_noncausal", 1, 8, 8, 300, 300, 128, False, 0, "float32"),
    # the bf16 tensor-core kernel's other head-dim buckets
    ("d128_bf16", 2, 8, 2, 700, 700, 128, True, 0, "bfloat16"),
    ("d32_bf16", 2, 16, 4, 1000, 1000, 32, True, 100, "bfloat16"),
    # the MoE family's prefill at batch 8 x 2,048: qwen3-moe-235b-a22b's
    # 64 query heads on 4 KV heads (group 16) and grok-1-314b's 48 on 8
    # (group 6), D 128, causal, in bf16 and float32; all four timed
    ("moe_prefill", 8, 64, 4, 2048, 2048, 128, True, 0, "bfloat16"),
    ("moe_prefill_f32", 8, 64, 4, 2048, 2048, 128, True, 0, "float32"),
    ("grok_prefill", 8, 48, 8, 2048, 2048, 128, True, 0, "bfloat16"),
    ("grok_prefill_f32", 8, 48, 8, 2048, 2048, 128, True, 0, "float32"),
    # whisper-large-v3's prefill at batch 8: the encoder, non-causal over
    # 1,500 frames (the last 64-key tile holds 28 keys, in the middle of
    # a row), in bf16 and float32; the decoder's causal self-attention
    # over 448 tokens; the cross-attention, non-causal, 448 queries
    # against 1,500 keys
    ("whisper_enc", 8, 20, 20, 1500, 1500, 64, False, 0, "bfloat16"),
    ("whisper_enc_f32", 2, 20, 20, 1500, 1500, 64, False, 0, "float32"),
    ("whisper_dec", 8, 20, 20, 448, 448, 64, True, 0, "bfloat16"),
    ("whisper_cross", 8, 20, 20, 448, 1500, 64, False, 0, "bfloat16"),
    ("whisper_cross_f32", 2, 20, 20, 448, 1500, 64, False, 0, "float32"),
    # starcoder2-3b's prefill at 2 x 16,384: 24 query heads on 2 KV heads
    # (group 12), D 128, window 4,096 binding on three quarters of the
    # rows; group 12 alone, ragged, in bf16 and float32
    ("sc2_prefill", 2, 24, 2, 16384, 16384, 128, True, 4096, "bfloat16"),
    ("g12_d128_bf16", 2, 24, 2, 1000, 1000, 128, True, 0, "bfloat16"),
    ("g12_d128", 2, 24, 2, 1000, 1000, 128, True, 0, "float32"),
    ("g12_window_f32", 1, 24, 2, 2048, 2048, 128, True, 512, "float32"),
    # qwen2-vl-2b's prefill at batch 8 x 2,048: 12 query heads on 2 KV
    # heads (group 6), D 128, causal
    ("vlm_prefill", 8, 12, 2, 2048, 2048, 128, True, 0, "bfloat16"),
]
#: the flash cases timed (events and graph replay, bound, SDPA)
FLASH_TIMED = ("prefill", "rg_prefill", "moe_prefill", "moe_prefill_f32",
               "grok_prefill", "grok_prefill_f32", "whisper_enc",
               "whisper_dec", "whisper_cross", "sc2_prefill", "vlm_prefill")
#: cases checked against the plain version on a cut of their inputs (the
#: plain version's float32 scores of the whole case would not fit: 51.5 GB
#: at starcoder2-3b's 2 x 24 x 16,384^2), timed whole: batch, query and
#: key rows of the cut (the first rows of a causal case see only the
#: first keys, so the cut is the same function)
FLASH_CHECKED_AT = {"whisper_enc": (2, 1500, 1500),
                    "sc2_prefill": (1, 8192, 8192)}


def _to_query_heads(t, hq: int):
    """``t`` [B, Hkv, S, D] with each KV head repeated for its group of
    query heads (a view where Hkv is 1 or Hq, else a copy): SDPA's
    inputs."""
    hkv = t.shape[1]
    if hkv in (1, hq):
        return t.expand(t.shape[0], hq, *t.shape[2:])
    return t.repeat_interleave(hq // hkv, dim=1)


def _sdpa_mask(sq: int, skv: int, causal: bool, window: int) -> dict:
    """SDPA's keywords for the kernel's mask: none, ``is_causal`` (SDPA
    aligns its diagonal top-left, the kernel bottom-right: the same where
    Sq = Skv), or an explicit boolean mask where a window binds."""
    from repro_torch.kernels.flash_attention.ref import visible_mask
    binds = 0 < window < skv
    if not causal and not binds:
        return {}
    if causal and sq == skv and not binds:
        return {"is_causal": True}
    return {"attn_mask": visible_mask(sq, skv, causal, window, "cuda")}


def phase_flash_kernel() -> dict:
    """``flash_attention`` against its plain version on the same CUDA
    tensors; returns the timing rows of the main paths' shapes, by case
    name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    rows = {}
    for name, b, hq, hkv, sq, skv, d, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device="cuda").manual_seed(sq * hq + window)
        q = torch.randn((b, hq, sq, d), device="cuda", generator=gen
                        ).to(dtype)
        k = torch.randn((b, hkv, skv, d), device="cuda", generator=gen
                        ).to(dtype)
        v = torch.randn((b, hkv, skv, d), device="cuda", generator=gen
                        ).to(dtype)
        cb, csq, cskv = FLASH_CHECKED_AT.get(name, (b, sq, skv))
        qc, kc, vc = (q[:cb, :, :csq].contiguous(),
                      k[:cb, :, :cskv].contiguous(),
                      v[:cb, :, :cskv].contiguous())
        got = flash_attention(qc, kc, vc, causal=causal, window=window)
        torch.cuda.synchronize()
        want = attention_ref(qc, kc, vc, causal=causal, window=window)
        require(got.dtype == dtype, f"flash {name}: output {got.dtype}")
        atol, rtol = ((F32_ATOL, F32_RTOL) if dtype == torch.float32
                      else (F32_ATOL, BF16_STEP_RTOL))
        want = want.to(dtype).float()
        err = _close(got, want, atol, rtol, f"flash {name}")
        # the largest share of its limit that an element uses
        share = float(((got.float() - want).abs()
                       / (atol + rtol * want.abs())).max())
        del want
        entry = {"phase": "kernel", "name": "flash_attention", "case": name,
                 "shape": [b, hq, hkv, sq, skv, d], "causal": causal,
                 "window": window, "dtype": dt, "max_abs_err": err,
                 "tol": [atol, rtol], "tol_share": share}
        if name in FLASH_CHECKED_AT:
            entry["checked_shape"] = [cb, hq, hkv, csq, cskv, d]
        del got
        if name in FLASH_TIMED:
            elt = q.element_size()
            nbytes = elt * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
            flops = 4 * b * hq * d * visible_pairs(sq, skv, causal, window)
            # float32 runs on the CUDA cores (FP32 peak), bf16 on the
            # tensor cores
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S
                               if dtype == torch.bfloat16 else FP32_OPS_PER_S)
            kernel = (lambda: flash_attention(q, k, v, causal=causal,
                                              window=window))
            # SDPA under the same mask (_sdpa_mask), its k and v expanded
            # to Hq heads; the plain version at the checked shape (the
            # whole case's where it is not cut)
            ke, ve = _to_query_heads(k, hq), _to_query_heads(v, hq)
            mask = _sdpa_mask(sq, skv, causal, window)
            entry.update(
                ms=cuda_ms(kernel, 10), graph_ms=graph_ms(kernel, 3, 5),
                plain_ms=cuda_ms(lambda: attention_ref(
                    qc, kc, vc, causal=causal, window=window), 3),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, **mask), 10),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
            if name in FLASH_CHECKED_AT:
                entry["plain_ms_at"] = entry["checked_shape"]
            rows[name] = entry
            del ke, ve, mask
        emit(entry)
        del q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    return rows


DECODE_CASES = [
    # (b, hq, hkv, s, d, kv_len, q dtype, cache dtype); qwen1.5-0.5b's
    # serve path is batch 8, 16 heads, D 64 against S = 640;
    # recurrentgemma-9b's is batch 8, 16 query heads on one KV head (group
    # 16), D 256, against a window of S = 2,048; kv_len 7 and 9 take one
    # split (kernels/decode_attention/kernel.py::split_plan), 1,000 (32
    # of 32 keys, the last 8) and the GQA group's 300 end in a ragged
    # split
    (8, 16, 16, 640, 64, 1, "bfloat16", "bfloat16"),
    (8, 16, 16, 640, 64, 7, "bfloat16", "bfloat16"),
    (8, 16, 16, 640, 64, 65, "bfloat16", "bfloat16"),
    (8, 16, 16, 640, 64, 300, "bfloat16", "bfloat16"),
    (8, 16, 16, 640, 64, 640, "bfloat16", "bfloat16"),
    (8, 16, 16, 640, 64, 1, "float32", "bfloat16"),
    (8, 16, 16, 640, 64, 300, "float32", "bfloat16"),
    (8, 16, 16, 640, 64, 640, "float32", "bfloat16"),
    (8, 16, 16, 640, 64, 300, "float32", "float32"),
    (8, 32, 4, 640, 64, 300, "float32", "bfloat16"),
    (8, 32, 4, 640, 64, 640, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 1, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 9, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 192, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 1000, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 2048, "bfloat16", "bfloat16"),
    (8, 16, 1, 2048, 256, 192, "float32", "bfloat16"),
    (8, 16, 1, 2048, 256, 1000, "float32", "float32"),
    # the MoE family's serve paths, D 128: qwen3-moe-235b-a22b's 64 query
    # heads on 4 KV heads (group 16) against S = 160 (prompt 128 + gen
    # 32), grok-1-314b's 48 on 8 (group 6) against S = 80 (64 + 16);
    # kv_len 100 (7 splits of 16, the last 4 keys), 33 and 80 (splits of
    # 16 and 32 keys, the last 1 and 16) end in a ragged split, and a
    # cache of 2,048 at kv_len 1,000 in both groups
    (8, 64, 4, 160, 128, 1, "bfloat16", "bfloat16"),
    (8, 64, 4, 160, 128, 9, "bfloat16", "bfloat16"),
    (8, 64, 4, 160, 128, 100, "bfloat16", "bfloat16"),
    (8, 64, 4, 160, 128, 160, "bfloat16", "bfloat16"),
    (8, 64, 4, 160, 128, 100, "float32", "bfloat16"),
    (8, 64, 4, 160, 128, 160, "float32", "bfloat16"),
    (8, 64, 4, 2048, 128, 1000, "bfloat16", "bfloat16"),
    (8, 48, 8, 80, 128, 1, "bfloat16", "bfloat16"),
    (8, 48, 8, 80, 128, 33, "bfloat16", "bfloat16"),
    (8, 48, 8, 80, 128, 80, "bfloat16", "bfloat16"),
    (8, 48, 8, 80, 128, 80, "float32", "bfloat16"),
    (8, 48, 8, 2048, 128, 1000, "float32", "float32"),
    # whisper-large-v3's serve path, 20 heads, D 64 (group 1): the
    # self-attention against S = 128 (prompt 64 + gen 64) and the
    # cross-attention against the 1,500 encoder keys (one split at any
    # kv_len: 160 blocks each reading all 1,500 keys)
    (8, 20, 20, 128, 64, 1, "bfloat16", "bfloat16"),
    (8, 20, 20, 128, 64, 128, "bfloat16", "bfloat16"),
    (8, 20, 20, 1500, 64, 1500, "bfloat16", "bfloat16"),
    (8, 20, 20, 1500, 64, 1500, "float32", "bfloat16"),
    (8, 20, 20, 1500, 64, 1500, "float32", "float32"),
    # starcoder2-3b's, 24 query heads on 2 KV heads (group 12), D 128,
    # against S = 192 (prompt 128 + gen 64), and its full window S_buf
    # 4,096 at kv_len 1 and 4,096 (a wrapped ring: every slot valid)
    (8, 24, 2, 192, 128, 1, "bfloat16", "bfloat16"),
    (8, 24, 2, 192, 128, 100, "bfloat16", "bfloat16"),
    (8, 24, 2, 192, 128, 192, "bfloat16", "bfloat16"),
    (8, 24, 2, 192, 128, 192, "float32", "bfloat16"),
    (8, 24, 2, 4096, 128, 1, "bfloat16", "bfloat16"),
    (8, 24, 2, 4096, 128, 4096, "bfloat16", "bfloat16"),
    (8, 24, 2, 4096, 128, 4096, "float32", "float32"),
    # qwen2-vl-2b's, 12 query heads on 2 KV heads (group 6), D 128,
    # against S = 192
    (8, 12, 2, 192, 128, 192, "bfloat16", "bfloat16"),
    (8, 12, 2, 192, 128, 77, "float32", "bfloat16"),
]
#: the timed decode rows, (Hq, D, kv_len) of the bf16 serve shapes' longest
#: steps: qwen's, recurrentgemma-9b's full window (the steady state of
#: long serving), qwen3-moe-235b-a22b's and grok-1-314b's; whisper's
#: self- and cross-attention, starcoder2-3b's (and its full window) and
#: qwen2-vl-2b's
DECODE_TIMED = {(16, 64, 640): "qwen", (16, 256, 2048): "rg",
                (64, 128, 160): "moe", (48, 128, 80): "grok",
                (20, 64, 128): "whisper_self", (20, 64, 1500): "whisper_cross",
                (24, 128, 192): "sc2", (24, 128, 4096): "sc2_window",
                (12, 128, 192): "vlm"}


def phase_decode_kernel() -> dict:
    """``decode_attention`` against its plain version on the same CUDA
    tensors: the partials acc, m, l (float32 outputs of exact float32
    copies of the inputs, so the float32 tolerance holds for every input
    type), and the normalized output that the fold writes in q's dtype
    (float32 limits, or one bf16 step for a bf16 q); returns the timing
    rows of the serve paths' longest steps (bf16), by ``DECODE_TIMED``'s
    name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (combine_partials,
                                                      decode_attention,
                                                      decode_attention_partial,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention.kernel import split_plan
    rows = {}
    for b, hq, hkv, s, d, kv_len, qdt, kvdt in DECODE_CASES:
        gen = torch.Generator(device="cuda").manual_seed(kv_len + hq)
        q = torch.randn((b, hq, d), device="cuda", generator=gen
                        ).to(getattr(torch, qdt))
        k = torch.randn((b, hkv, s, d), device="cuda", generator=gen
                        ).to(getattr(torch, kvdt))
        v = torch.randn((b, hkv, s, d), device="cuda", generator=gen
                        ).to(getattr(torch, kvdt))
        what = (f"decode [{b},{hq},{hkv},{s},{d}] kv_len {kv_len} "
                f"{qdt}/{kvdt}")
        got = decode_attention_partial(q, k, v, kv_len=kv_len)
        out = decode_attention(q, k, v, kv_len=kv_len)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, k, v, kv_len=kv_len)
        for g, w, part in zip(got, want, ("acc", "m", "l")):
            _close(g, w, F32_ATOL, F32_RTOL, f"{what} {part}")
        want_out = combine_partials(*(t[None] for t in want))
        err = _close(combine_partials(*(t[None] for t in got)), want_out,
                     F32_ATOL, F32_RTOL, f"{what} output")
        require(out.dtype == q.dtype, f"{what}: output {out.dtype}")
        rtol = F32_RTOL if q.dtype == torch.float32 else BF16_STEP_RTOL
        err_out = _close(out, want_out.to(q.dtype), F32_ATOL, rtol,
                         f"{what} normalized output")
        splits, chunk = split_plan(b, hkv, kv_len, hq // hkv)
        entry = {"phase": "kernel", "name": "decode_attention",
                 "shape": [b, hq, hkv, s, d], "kv_len": kv_len,
                 "splits": splits, "chunk": chunk, "q_dtype": qdt,
                 "cache_dtype": kvdt, "max_abs_err": err,
                 "normalized_max_abs_err": err_out,
                 "tol": [F32_ATOL, F32_RTOL]}
        timed = DECODE_TIMED.get((hq, d, kv_len))
        if timed and (qdt, kvdt) == ("bfloat16", "bfloat16"):
            nbytes = (q.element_size() * b * hq * d
                      + k.element_size() * 2 * b * hkv * kv_len * d
                      + q.element_size() * b * hq * d)
            flops = 4 * b * hq * kv_len * d
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            # one query against the cache cut to kv_len, k and v expanded
            # to Hq heads
            q1 = q[:, :, None]
            kc = _to_query_heads(k[:, :, :kv_len], hq)
            vc = _to_query_heads(v[:, :, :kv_len], hq)
            # the card's time from graph replays (a call is ~10-60 us of
            # device work under ~40 us of host launch cost), and one
            # call's events, host included, beside it
            normalized = (lambda: decode_attention(q, k, v, kv_len=kv_len))
            sdpa = (lambda: F.scaled_dot_product_attention(q1, kc, vc))
            entry.update(
                ms=graph_ms(normalized),
                plain_ms=cuda_ms(lambda: combine_partials(*(
                    t[None] for t in decode_attention_ref(
                        q, k, v, kv_len=kv_len))).to(q.dtype), 10),
                library_ms=graph_ms(sdpa),
                partial_ms=graph_ms(lambda: decode_attention_partial(
                    q, k, v, kv_len=kv_len)),
                event_ms=cuda_ms(normalized, 50),
                library_event_ms=cuda_ms(sdpa, 50),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
            rows[timed] = entry
            del q1, kc, vc
        emit(entry)
        del q, k, v, got, want, out, want_out
    torch.cuda.empty_cache()
    return rows


#: kernel-name parts the prefill and serve traces sum: the attention
#: kernels, cuBLAS's GEMMs on the H100 (named nvjet_*, or *gemm*) and
#: PyTorch's elementwise kernels
PROFILE_NAMES = ("flash_attention_mma_kernel", "flash_attention_kernel",
                 "decode_attention_kernel", "decode_attention_fold_kernel",
                 "nvjet", "gemm", "elementwise")


def _profile(fn, names: tuple[str, ...]) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall, device busy
    share, the device time of kernels whose name holds each of
    ``names``, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda r: -r[1])
    require(kernels, "the trace shows no kernel on the card")
    busy = sum(k[1] for k in kernels)
    return {"wall_ms_traced": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "kernels_launched": sum(c for _, _, c in kernels),
            "kernel_ms": {n: sum(t for k, t, _ in kernels if n in k)
                          for n in names},
            "kernel_launches": {n: sum(c for k, _, c in kernels if n in k)
                                for n in names},
            "top": [{"kernel": k[:90], "ms": t, "calls": c}
                    for k, t, c in kernels[:8]]}


def _require_split_decode(prof: dict, layers: int, cfg, batch: int,
                          kv_len: int, what: str) -> None:
    """The profiled decode step ran the split kernel once per attention
    layer, and its fold once per layer where the step's plan has several
    splits: the normalized output comes from the kernels, with no plain
    combination after them."""
    from repro_torch.kernels.decode_attention.kernel import split_plan
    group = cfg.n_heads // cfg.n_kv_heads
    splits, _ = split_plan(batch, cfg.n_kv_heads, kv_len, group)
    want = {"decode_attention_kernel": layers,
            "decode_attention_fold_kernel": layers if splits > 1 else 0}
    got = {n: prof["kernel_launches"][n] for n in want}
    require(got == want, f"{what}: the profiled step launched {got}, "
                         f"expected {want} ({splits} splits)")


def phase_prefill() -> int:
    """``make_prefill`` on qwen1.5-0.5b at full size, batch 8 x 2,048;
    returns the flash launches of the main-path (bf16) call."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models.registry import get_api
    cfg = get_config("qwen1.5-0.5b")
    (b, s), calls = PREFILL_SHAPE, 3
    model = get_api(cfg).init(cfg, seed=0, device="cuda")
    params = model.params()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    batch = {"tokens": tokens}
    prefill = make_prefill(cfg)
    prefill(params, batch)  # first call: the kernels' first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    walls = []
    for _ in range(calls):
        wall, logits = _timed(lambda: prefill(params, batch))
        walls.append(wall)
    launches = dispatch.launches["repro_flash_attention"]
    require(launches == cfg.n_layers * calls
            and sum(dispatch.launches.values()) == launches,
            f"prefill: launches {dispatch.launches} over {calls} calls")
    peak = torch.cuda.max_memory_allocated()
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            "prefill: logits are not finite float32 [8, vocab]")
    # the plain version of the flash kernel on the card, and the bf16
    # model's own distance from float32 compute: the kernel's bf16
    # logits must sit within the latter of the plain bf16 logits, as a
    # root mean square over all 8 x 151,936 logits (a steadier measure
    # than the largest of them, which is also reported)
    dense = make_prefill(cfg, attn_impl="dense")(params, batch)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    flash32 = make_prefill(cfg32)(params, batch)
    dense32 = make_prefill(cfg32, attn_impl="dense")(params, batch)
    err32 = float((flash32 - dense32).abs().max())
    require(err32 <= PREFILL_F32_TOL,
            f"prefill float32: flash vs plain logits differ by {err32}")

    def rms(t):
        return float(t.double().pow(2).mean().sqrt())

    bf16_noise = {"max_abs": float((dense - dense32).abs().max()),
                  "rms": rms(dense - dense32)}
    err = {"max_abs": float((logits - dense).abs().max()),
           "rms": rms(logits - dense)}
    require(err["rms"] <= bf16_noise["rms"],
            f"prefill bf16: flash vs plain logits differ by {err}, more "
            f"than bf16 compute moves them ({bf16_noise})")
    prof = _profile(lambda: prefill(params, batch), PROFILE_NAMES)
    emit({"phase": "prefill", "arch": "qwen1.5-0.5b", "layers": cfg.n_layers,
          "batch": b, "prompt": s, "compute_dtype": "bfloat16",
          "flash_launches_per_call": launches // calls,
          "wall_s": walls, "tok_per_s": [b * s / w for w in walls],
          "peak_mem_bytes": peak, "logits_err_vs_plain": err,
          "bf16_vs_f32_logits": bf16_noise,
          "f32_logits_max_abs_err_vs_plain": err32,
          "f32_tol": PREFILL_F32_TOL, "profiled_call": prof})
    del model, params
    torch.cuda.empty_cache()
    return launches


#: prefill: batch x prompt; serve: batch, prompt, generated tokens
PREFILL_SHAPE = (8, 2048)
SERVE_SHAPE = (8, 512, 128)
#: the float32 serve check's prompt and generated steps (the first of
#: the bf16 run's prompt): at 640 steps, each run twice in float32, it
#: took ~45 s of the script's time limit
SERVE_CHECK_STEPS = (128, 32)
#: float32 prefill logits, flash against plain: the same function with
#: sums in another order, through 24 layers (logits of order 1)
PREFILL_F32_TOL = 1e-3
#: float32 decode logits, kernel loop against the plain loop (each with
#: its own bf16 cache, fed the same tokens): a key or value near a bf16
#: rounding edge may round one step apart in the two caches (2^-8
#: relative), which moves the logits by much more than the float32 sums
SERVE_F32_TOL = 1e-2
#: the first generated token's logits against the prefill's: the serve
#: loop's cache holds k and v rounded to bf16, the prefill's attention
#: uses them in float32 (a relative step of 2^-8 on each)
SERVE_VS_PREFILL_TOL = 5e-2


def phase_serve() -> int:
    """The ``launch.serve`` loop on qwen1.5-0.5b at full size: the float32
    check (SERVE_CHECK_STEPS), then the bf16 (config) run at batch 8,
    prompt 512, gen 128 with its times; returns the decode launches of
    the bf16 run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill, make_serve_step
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_api
    cfg = get_config("qwen1.5-0.5b")
    (b, plen, gen), seed = SERVE_SHAPE, 0
    kv_len = plen + gen
    model = get_api(cfg).init(cfg, seed=seed, device="cuda")
    params = model.params()
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab,
                                                 size=(b, plen))

    # float32 compute: each kernel step against the plain step, fed the
    # kernel loop's tokens, with a cache of its own
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cplen, cgen = SERVE_CHECK_STEPS
    cprompt = prompt[:, :cplen]
    plain_cache = transformer.init_cache(cfg32, b, cplen + cgen)
    stats = {"max_err": 0.0, "near_ties": 0, "near_tie_steps": 0,
             "steps": 0, "first_logits": None}

    def observe(dbatch, logits):
        want, _ = transformer.decode_step(params, plain_cache, dbatch,
                                          cfg32, impl="dense")
        err = float((logits - want).abs().max())
        require(bool(torch.isfinite(logits).all()),
                f"serve float32 step {dbatch['index']}: logits not finite")
        require(err <= SERVE_F32_TOL,
                f"serve float32 step {dbatch['index']}: logits differ from "
                f"the plain step by {err}")
        top2 = want.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= SERVE_F32_TOL
        differ = logits.argmax(-1) != want.argmax(-1)
        require(not bool((differ & ~tie).any()),
                f"serve float32 step {dbatch['index']}: a greedy token "
                "differs from the plain step's away from a near-tie")
        stats["max_err"] = max(stats["max_err"], err)
        stats["near_ties"] += int((differ & tie).sum())
        stats["near_tie_steps"] += int(tie.any())
        stats["steps"] += 1
        if dbatch["index"] == cplen - 1:
            stats["first_logits"] = logits.clone()

    with torch.no_grad():
        res32 = generate(cfg32, params, cprompt, cgen, observe=observe)
    require(stats["steps"] == cplen + cgen,
            f"serve float32: {stats['steps']} steps observed")
    pre = make_prefill(cfg32)(params, {"tokens": cprompt})
    err_pre = float((stats["first_logits"] - pre).abs().max())
    require(err_pre <= SERVE_VS_PREFILL_TOL,
            f"serve float32: the first generated token's logits differ from "
            f"the prefill's by {err_pre}")
    require(res32["tokens"].shape == (b, cgen),
            f"serve float32: tokens {res32['tokens'].shape}")
    del plain_cache, res32, pre
    emit({"phase": "serve_check", "arch": "qwen1.5-0.5b",
          "compute_dtype": "float32", "cache_dtype": "bfloat16", "batch": b,
          "prompt": cplen, "gen": cgen, "steps": stats["steps"],
          "logits_max_abs_err_vs_plain": stats["max_err"],
          "tol": SERVE_F32_TOL,
          "greedy_tokens_differing_at_near_ties": stats["near_ties"],
          "steps_with_a_near_tie": stats["near_tie_steps"],
          "first_token_logits_vs_prefill_max_abs": err_pre,
          "first_token_vs_prefill_tol": SERVE_VS_PREFILL_TOL})

    # the config's bf16: the main path, timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = generate(cfg, params, prompt, gen)
    launches = dispatch.launches["repro_decode_attention"]
    require(launches == cfg.n_layers * kv_len
            and sum(dispatch.launches.values()) == launches,
            f"serve: launches {dispatch.launches} over {kv_len} steps")
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(toks.shape == (b, gen) and toks.min() >= 0
            and toks.max() < cfg.vocab, f"serve: tokens {toks.shape}")
    step = make_serve_step(cfg, kv_len, b)
    cache = res["cache"]
    last = {"tokens": torch.from_numpy(toks[:, -1:]).cuda(),
            "index": kv_len - 1}
    prof = _profile(lambda: step(params, cache, last), PROFILE_NAMES)
    _require_split_decode(prof, cfg.n_layers, cfg, b, kv_len, "serve")
    emit({"phase": "serve", "arch": "qwen1.5-0.5b",
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": gen, "decode_launches_per_step": launches // kv_len,
          "prompt_steps_s": res["prompt_s"], "gen_s": res["gen_s"],
          "ms_per_decode_step": res["gen_s"] / gen * 1e3,
          "gen_tok_per_s": b * gen / res["gen_s"], "peak_mem_bytes": peak,
          "sample_row": toks[0][:16].tolist(), "profiled_step": prof})
    del model, params, res, cache
    torch.cuda.empty_cache()
    return launches


#: the selective scan's bound (``csrc/ssm_scan.cu``): an H100 SXM has 132
#: SMs, each with 128 float32 lanes and 16 special-function results
#: (exp2) per clock (CUDA C Programming Guide, arithmetic instructions,
#: compute capability 9.0)
H100_SMS = 132
FP32_LANES_PER_SM = 128
SFU_PER_SM = 16
#: float32 instructions per (row, step, channel, state) as the source
#: spells them out: dt·A2 (the exponent, A2 = A·log2 e formed once a
#: block), dA·h and dbx·B (each rounded), their sum and the FMA of y; and
#: two per (row, step, channel): dt·x and the add of y's two halves
SSM_FP32_PER_STATE = 5
SSM_FP32_PER_CHANNEL = 2
#: the selective scan's cases, held to the attention kernels' tolerances
#: (float32 output 2e-5 + 1e-4 relative; bfloat16 output 2e-2)
SSM_CASES = [
    # (name, b, s, di, st, dtype, A scale); the first is falcon-mamba-7b's
    # prefill at batch 8 x 2,048, the main path's shape
    ("prefill", 8, 2048, 8192, 16, "bfloat16", 1.0),
    ("prefill_f32", 8, 2048, 8192, 16, "float32", 1.0),
    ("ragged", 2, 1000, 1000, 16, "float32", 1.0),
    ("ragged_bf16", 2, 1000, 1000, 16, "bfloat16", 1.0),
    ("st4_smoke", 2, 512, 1024, 4, "float32", 1.0),
    # |A| of 1e-3..1.6e-2 at dt ~ 0.01: h keeps ~all of its past over
    # 4,096 steps, so the carry decides every late output
    ("carry_4096", 2, 4096, 512, 16, "float32", 1e-3),
    # 1,001 channels: rows off 16 bytes take the element-wise copies and
    # stores; st 5 pads each half of the states to 3
    ("unaligned_st5", 2, 300, 1001, 5, "bfloat16", 1.0),
    ("unaligned_st5_f32", 2, 300, 1001, 5, "float32", 1.0),
]
#: cases held against a float64 scan instead of the plain version: the
#: kernel's ex2.approx and the plain version's torch.exp (expf, which
#: evaluates ex2 after reducing its argument to [0, 1)) land on other
#: last bits of factors near 1, and a nearly undamped carry adds those up
#: over 4,096 steps past the float32 limit; the kernel must be no farther
#: from the float64 scan than the plain version is
SSM_F64_CASES = ("carry_4096",)
#: the selective-scan kernel's instantiations: float32 and bf16 × 1..8
#: states a thread (st 1..16 split in two halves)
SSM_INSTANTIATIONS = 16
#: x_proj's dt_rank columns ahead of B and C (falcon-mamba-7b): the
#: kernel reads B and C as strided slices of one [B, S, 288] tensor
SSM_DT_RANK = 256


def _sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def ssm_bound(b: int, s: int, di: int, st: int, elt: int,
              clock_hz: float) -> dict:
    """The least time of one selective scan: the largest of the bytes
    over 3.35 TB/s, the float32 instructions over the lanes' rate and the
    exponentials over the special-function units' rate."""
    n = b * s * di * st
    nbytes = (elt * b * s * di * 2 + 4 * b * s * di + elt * 2 * b * s * st
              + 4 * di * st)
    fp32 = SSM_FP32_PER_STATE * n + SSM_FP32_PER_CHANNEL * b * s * di
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32": fp32 / (H100_SMS * FP32_LANES_PER_SM * clock_hz) * 1e3,
             "exp": n / (H100_SMS * SFU_PER_SM * clock_hz) * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms, "bytes": nbytes,
            "fp32_instructions": fp32, "expf": n, "sm_clock_hz": clock_hz}


def _ptxas_entries(log: str, kernel: str) -> list[dict]:
    """Registers and stack of each instantiation of ``kernel`` that ptxas
    reported (its ``-v`` lines)."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "entry function" not in ln or kernel not in ln:
            continue
        name = ln.split("'")[1]
        frame = next((x.strip() for x in lines[i + 1:]
                      if "stack frame" in x), "")
        regs = next((x.strip() for x in lines[i + 1:] if "registers" in x),
                    "")
        out.append({"entry": name, "stack": frame, "registers": regs})
    return out


def _ssm_inputs(b, s, di, st, dtype, a_scale, seed):
    """x, dt, B, C, A on the card as the model makes them: dt a softplus
    of a normal around -4.6 (``dt_bias``), B and C strided slices of one
    x_proj output, A = -(1..st)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, di), device="cuda", generator=gen).to(dtype)
    dt = torch.logaddexp(
        torch.randn((b, s, di), device="cuda", generator=gen) - 4.6,
        torch.zeros((), device="cuda"))
    dbc = torch.randn((b, s, SSM_DT_RANK + 2 * st), device="cuda",
                      generator=gen).to(dtype)
    bc = dbc[..., SSM_DT_RANK:SSM_DT_RANK + st]
    cc = dbc[..., SSM_DT_RANK + st:]
    a = -(torch.arange(1, st + 1, dtype=torch.float32, device="cuda")
          * a_scale).repeat(di, 1)
    return x, dt, bc, cc, a


def _ssm_f64(x, dt, bc, cc, a):
    """The plain version's recurrence in float64: how far each float32
    path is from the exact scan of the same inputs."""
    import torch
    xd, dtd, bd, cd, ad = (t.double() for t in (x, dt, bc, cc, a))
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]),
                    dtype=torch.float64, device=x.device)
    ys = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for t in range(x.shape[1]):
        h = (torch.exp(dtd[:, t, :, None] * ad[None]) * h
             + (dtd[:, t] * xd[:, t])[..., None] * bd[:, t, None, :])
        ys[:, t] = torch.einsum("bdn,bn->bd", h, cd[:, t])
    return ys


def phase_ssm_kernel() -> dict:
    """``ssm_scan`` against its plain version on the same CUDA tensors;
    returns the timing row of the prefill shape."""
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    from repro_torch.kernels.ssm_scan.kernel import launch_plan
    entries = _require_no_stack("ssm_scan_kernel", SSM_INSTANTIATIONS)
    clock = _sm_clock_hz()
    row = None
    for i, (name, b, s, di, st, dt_name, a_scale) in enumerate(SSM_CASES):
        dtype = getattr(torch, dt_name)
        x, dt, bc, cc, a = _ssm_inputs(b, s, di, st, dtype, a_scale, i)
        got = ssm_scan(x, dt, bc, cc, a)
        torch.cuda.synchronize()
        want = ssm_scan_ref(x, dt, bc, cc, a)
        require(got.dtype == dtype and got.shape == (b, s, di),
                f"ssm_scan {name}: output {got.dtype} {tuple(got.shape)}")
        f64 = {}
        if name in SSM_F64_CASES:
            exact = _ssm_f64(x, dt, bc, cc, a)
            f64 = {"kernel_max_abs_err_vs_f64":
                   float((got.double() - exact).abs().max()),
                   "plain_max_abs_err_vs_f64":
                   float((want.double() - exact).abs().max())}
            del exact
            require(f64["kernel_max_abs_err_vs_f64"]
                    <= f64["plain_max_abs_err_vs_f64"],
                    f"ssm_scan {name}: the kernel is farther from the "
                    f"float64 scan than the plain version: {f64}")
            err, tol = float((got - want).abs().max()), "f64"
        elif dtype == torch.float32:
            err = _close(got, want, F32_ATOL, F32_RTOL, f"ssm_scan {name}")
            tol = [F32_ATOL, F32_RTOL]
        else:
            err = _close(got, want.to(dtype), BF16_ATOL, 0.0,
                         f"ssm_scan {name}")
            tol = [BF16_ATOL, 0.0]
        entry = {"phase": "kernel", "name": "ssm_scan", "case": name,
                 "shape": [b, s, di, st], "dtype": dt_name,
                 "a_scale": a_scale, "max_abs_err": err,
                 # the share of outputs not equal to the plain version's
                 "differs": float((got.float() != want.to(dtype).float())
                                  .float().mean()),
                 "max_abs_y": float(want.abs().max()), "tol": tol, **f64}
        if name in ("prefill", "prefill_f32"):
            entry.update(
                ms=cuda_ms(lambda: ssm_scan(x, dt, bc, cc, a), 10),
                graph_ms=graph_ms(lambda: ssm_scan(x, dt, bc, cc, a), 5, 10),
                plain_ms=cuda_ms(lambda: ssm_scan_ref(x, dt, bc, cc, a), 1),
                # no single PyTorch call computes a selective scan
                library_ms=None,
                plan=launch_plan(b, di, st, dtype),
                ptxas=[e for e in entries if "Li8E" in e["entry"]],
                **ssm_bound(b, s, di, st, x.element_size(), clock))
            entry["bound_share"] = entry["bound_ms"] / entry["graph_ms"]
        if name == "prefill":
            row = entry
        emit(entry)
        del x, dt, bc, cc, a, got, want
    torch.cuda.empty_cache()
    return row


#: float32 operations per second of an H100 SXM (data sheet, outside the
#: tensor cores; a multiply and an add count one each)
FP32_OPS_PER_S = 67e12
#: the RG-LRU scan's cases: each held to its plain version on the same
#: CUDA tensors with torch.equal (both round each product and each sum
#: alike); a in (0.9, 1) as the model's decay, b normal
LRU_CASES = [
    # (name, b, s, w, dtype, a fixed or None); the first is
    # recurrentgemma-9b's prefill at batch 8 x 2,048 (its a and b are
    # float32), the main path's shape, timed
    ("prefill", 8, 2048, 4096, "float32", None),
    ("prefill_bf16", 8, 2048, 4096, "bfloat16", None),
    ("ragged", 3, 1000, 1000, "float32", None),
    # a = 0.9999: h keeps nearly all of its past over 4,096 steps, so
    # every step's rounding is carried to the end
    ("carry_4096", 2, 4096, 1024, "float32", 0.9999),
]


def _lru_inputs(b, s, w, dtype, a_fixed, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if a_fixed is None:
        a = 0.9 + 0.1 * torch.rand((b, s, w), device="cuda", generator=gen)
    else:
        a = torch.full((b, s, w), a_fixed, device="cuda")
    bb = torch.randn((b, s, w), device="cuda", generator=gen) * 0.1
    return a.to(dtype), bb.to(dtype)


def _lru_f64(a, b):
    """The recurrence in float64: how far the float32 carry is from the
    exact scan of the same inputs."""
    import torch
    ad, bd = a.double(), b.double()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float64,
                    device=a.device)
    hs = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    for t in range(a.shape[1]):
        h = ad[:, t] * h + bd[:, t]
        hs[:, t] = h
    return hs


def _require_no_stack(kernel: str, count: int) -> list[dict]:
    """ptxas's lines of ``kernel``'s ``count`` instantiations; each must
    show no stack frame and no spill."""
    from repro_torch.kernels import dispatch
    entries = _ptxas_entries(dispatch.load_library()["log"], kernel)
    require(len(entries) == count,
            f"ptxas reported {len(entries)} {kernel} instantiations, "
            f"expected {count}")
    for e in entries:
        require(e["stack"].startswith("0 bytes stack frame, 0 bytes spill "
                                      "stores, 0 bytes spill loads"),
                f"{e['entry']} uses a stack frame or spills: "
                f"{e['stack']!r}")
    return entries


#: instantiations of each attention kernel: flash in float32 and in bf16
#: at D up to 32, 64, 128, 256; the decode split kernel with 4 rows a team
#: at two cache types × four head-dim buckets, and with one row a team
#: (keys straight to registers) at bf16 D ≤ 32, 64 and float32 D ≤ 32;
#: its fold
ATTENTION_INSTANTIATIONS = {"flash_attention_kernel": 4,
                            "flash_attention_mma_kernel": 4,
                            "decode_attention_kernel": 11,
                            "decode_attention_fold_kernel": 1}
#: SASS that shows the bf16 flash kernel on the tensor cores (mma.sync is
#: HMMA, wgmma HGMMA) and copying asynchronously (cp.async is LDGSTS, TMA
#: UTMALDG)
TENSOR_CORE_SASS = ("HMMA", "HGMMA")
ASYNC_COPY_SASS = ("LDGSTS", "UTMALDG")


def phase_attention_ptxas() -> None:
    """Every instantiation of the attention kernels keeps everything in
    registers, and every bf16 flash instantiation's SASS holds
    tensor-core products and asynchronous copies."""
    emit({"phase": "build", "ptxas_check": {
        kernel: _require_no_stack(kernel, count)
        for kernel, count in ATTENTION_INSTANTIATIONS.items()}})
    emit({"phase": "build", "sass_check": _flash_sass()})


def _flash_sass() -> dict:
    """The tensor-core and asynchronous-copy instructions that
    ``cuobjdump -sass`` shows in each bf16 flash instantiation of the
    built library."""
    from repro_torch.kernels import dispatch
    tool = Path(dispatch._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    sass = subprocess.run(
        [str(tool), "-sass", dispatch.load_library()["path"]],
        capture_output=True, text=True, timeout=300, check=True).stdout
    found = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "flash_attention_mma_kernel" not in name:
            continue
        found[name] = {op: section.count(op) for op in
                       TENSOR_CORE_SASS + ASYNC_COPY_SASS}
    want = ATTENTION_INSTANTIATIONS["flash_attention_mma_kernel"]
    require(len(found) == want, f"cuobjdump shows {len(found)} bf16 flash "
                                f"instantiations, expected {want}")
    for name, ops in found.items():
        require(any(ops[op] for op in TENSOR_CORE_SASS),
                f"{name}: no tensor-core instruction in its SASS ({ops})")
        require(any(ops[op] for op in ASYNC_COPY_SASS),
                f"{name}: no asynchronous copy in its SASS ({ops})")
    return found


def phase_lru_kernel() -> dict:
    """``lru_scan`` against its plain version on the same CUDA tensors;
    returns the timing row of the prefill shape."""
    import torch
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_ref
    entries = _require_no_stack("lru_scan_kernel", 2)
    row = None
    for i, (name, b, s, w, dt_name, a_fixed) in enumerate(LRU_CASES):
        dtype = getattr(torch, dt_name)
        a, bb = _lru_inputs(b, s, w, dtype, a_fixed, i)
        got = lru_scan(a, bb)
        torch.cuda.synchronize()
        want = lru_scan_ref(a, bb).to(dtype)
        require(got.dtype == dtype and got.shape == (b, s, w),
                f"lru_scan {name}: output {got.dtype} {tuple(got.shape)}")
        diff = float((got.float() - want.float()).abs().max())
        require(torch.equal(got, want),
                f"lru_scan {name}: kernel differs from its plain version "
                f"(max abs err {diff})")
        entry = {"phase": "kernel", "name": "lru_scan", "case": name,
                 "shape": [b, s, w], "dtype": dt_name, "a": a_fixed,
                 "max_abs_err": 0.0, "equal": True,
                 "max_abs_h": float(want.float().abs().max())}
        if name == "carry_4096":
            err64 = float((got.double() - _lru_f64(a, bb)).abs().max())
            entry.update(kernel_max_abs_err_vs_f64=err64)
        if name == "prefill":
            n = b * s * w
            nbytes = 3 * a.element_size() * n
            b_ms, b_by = bound(nbytes, 2 * n, FP32_OPS_PER_S)
            entry.update(
                ms=cuda_ms(lambda: lru_scan(a, bb), 20),
                # device time, the host's launch taken out, as the other
                # kernels' rows
                graph_ms=graph_ms(lambda: lru_scan(a, bb), 10, 20),
                plain_ms=cuda_ms(lambda: lru_scan_ref(a, bb), 1),
                # no single PyTorch call computes a linear recurrence
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                ptxas=entries)
            row = entry
        emit(entry)
        del a, bb, got, want
    torch.cuda.empty_cache()
    return row


#: falcon-mamba-7b: prefill batch x prompt; serve batch, prompt, generated
SSM_PREFILL_SHAPE = (8, 2048)
#: the prefill checks against the chunked plain path run at this batch:
#: the plain path holds [B, S, di, st] float32 tensors (2.1 GB each here,
#: 8.6 GB at batch 8), several at once, beside 29 GB of weights
SSM_CHECK_BATCH = 2
SSM_SERVE_SHAPE = (8, 128, 64)
#: float32 prefill logits, the kernel path against the chunked plain
#: path: the same recurrence, scanned in another order (the chunked
#: path's associative scan) and y summed in another order, through 64
#: layers
SSM_PREFILL_F32_TOL = 1e-3
#: the first generated token's logits against the prefill's, both in
#: float32 compute with float32 states: the same function, the scan as
#: 128 decode steps against the kernel's loop, through 64 layers
SSM_SERVE_VS_PREFILL_TOL = 1e-3
SSM_PROFILE_NAMES = ("ssm_scan_kernel", "nvjet", "gemm", "elementwise")


def _rms(t) -> float:
    return float(t.double().pow(2).mean().sqrt())


def phase_ssm_prefill(cfg, params) -> int:
    """``make_prefill`` on falcon-mamba-7b at full size, batch 8 x 2,048;
    returns the selective-scan launches of the timed (bf16) calls."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_prefill
    (b, s), calls = SSM_PREFILL_SHAPE, 3
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    batch = {"tokens": tokens}
    prefill = make_prefill(cfg)
    prefill(params, batch)  # first call: the kernel's first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    walls = []
    for _ in range(calls):
        wall, logits = _timed(lambda: prefill(params, batch))
        walls.append(wall)
    launches = dispatch.launches["repro_ssm_scan"]
    require(launches == cfg.n_layers * calls
            and sum(dispatch.launches.values()) == launches,
            f"ssm prefill: launches {dispatch.launches} over {calls} calls")
    peak = torch.cuda.max_memory_allocated()
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            "ssm prefill: logits are not finite float32 [8, vocab]")
    prof = _profile(lambda: prefill(params, batch), SSM_PROFILE_NAMES)
    del logits
    # the checks against the chunked plain path, at batch 2
    sub = {"tokens": tokens[:SSM_CHECK_BATCH]}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    kern32 = make_prefill(cfg32)(params, sub)
    plain32 = make_prefill(cfg32, attn_impl="dense")(params, sub)
    err32 = float((kern32 - plain32).abs().max())
    require(bool(torch.isfinite(kern32).all()) and err32 <= SSM_PREFILL_F32_TOL,
            f"ssm prefill float32: kernel vs plain logits differ by {err32}")
    kern = make_prefill(cfg)(params, sub)
    plain = make_prefill(cfg, attn_impl="dense")(params, sub)
    bf16_noise = {"max_abs": float((plain - plain32).abs().max()),
                  "rms": _rms(plain - plain32)}
    err = {"max_abs": float((kern - plain).abs().max()),
           "rms": _rms(kern - plain)}
    require(err["rms"] <= bf16_noise["rms"],
            f"ssm prefill bf16: kernel vs plain logits differ by {err}, more "
            f"than bf16 compute moves them ({bf16_noise})")
    emit({"phase": "ssm_prefill", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": b, "prompt": s, "compute_dtype": "bfloat16",
          "ssm_scan_launches_per_call": launches // calls,
          "wall_s": walls, "tok_per_s": [b * s / w for w in walls],
          "peak_mem_bytes": peak, "check_batch": SSM_CHECK_BATCH,
          "logits_err_vs_plain": err, "bf16_vs_f32_logits": bf16_noise,
          "f32_logits_max_abs_err_vs_plain": err32,
          "f32_tol": SSM_PREFILL_F32_TOL, "profiled_call": prof})
    return launches


def phase_ssm_serve(cfg, params) -> None:
    """The ``launch.serve`` loop on falcon-mamba-7b at full size, batch 8,
    prompt 128, gen 64: the first token's logits against the prefill's in
    float32, then the config's bf16, timed."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill, make_serve_step
    (b, plen, gen), seed = SSM_SERVE_SHAPE, 0
    kv_len = plen + gen
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab,
                                                 size=(b, plen))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    first = {}

    def observe(dbatch, logits):
        if dbatch["index"] == plen - 1:
            first["logits"] = logits.clone()

    with torch.no_grad():
        generate(cfg32, params, prompt, 1, observe=observe)
    pre = make_prefill(cfg32)(params, {"tokens": prompt})
    require(bool(torch.isfinite(first["logits"]).all()),
            "ssm serve float32: logits not finite")
    err_pre = float((first["logits"] - pre).abs().max())
    require(err_pre <= SSM_SERVE_VS_PREFILL_TOL,
            f"ssm serve float32: the first generated token's logits differ "
            f"from the prefill's by {err_pre}")
    del pre, first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = generate(cfg, params, prompt, gen)
    # the SSM decode step has no hand-written kernel (nor has the
    # reference's ssm_block_step)
    require(sum(dispatch.launches.values()) == 0,
            f"ssm serve: launches {dispatch.launches}")
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(toks.shape == (b, gen) and toks.min() >= 0
            and toks.max() < cfg.vocab, f"ssm serve: tokens {toks.shape}")
    step = make_serve_step(cfg, kv_len, b)
    cache = res["cache"]
    last = {"tokens": torch.from_numpy(toks[:, -1:]).cuda(),
            "index": kv_len - 1}
    prof = _profile(lambda: step(params, cache, last), SSM_PROFILE_NAMES)
    emit({"phase": "ssm_serve", "arch": cfg.name, "compute_dtype": "bfloat16",
          "batch": b, "prompt": plen, "gen": gen,
          "kernel_launches_per_step": 0,
          "cuda_kernels_per_step": prof["kernels_launched"],
          "prompt_steps_s": res["prompt_s"], "gen_s": res["gen_s"],
          "ms_per_decode_step": res["gen_s"] / gen * 1e3,
          "gen_tok_per_s": b * gen / res["gen_s"], "peak_mem_bytes": peak,
          "f32_first_token_logits_vs_prefill_max_abs": err_pre,
          "f32_first_token_vs_prefill_tol": SSM_SERVE_VS_PREFILL_TOL,
          "sample_row": toks[0][:16].tolist(), "profiled_step": prof})


def phase_ssm() -> int:
    """falcon-mamba-7b at full width and depth (64 layers, 7.27 B
    parameters, random weights from seed 0): prefill, then serving;
    returns the prefill's selective-scan launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api
    cfg = get_config("falcon-mamba-7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = get_api(cfg).init(cfg, seed=0, device="cuda")
    # the reference's analytic count (ArchConfig.param_count) leaves out
    # A_log [di, st] and one [di] vector of every layer, and the final
    # norm
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.param_count() + cfg.d_model + cfg.n_layers * (
        cfg.d_inner * cfg.ssm_state + cfg.d_inner),
        f"falcon-mamba-7b: {n_params} parameters")
    emit({"phase": "ssm_init", "params": n_params,
          "param_count_analytic": cfg.param_count(),
          "allocated_before_init_bytes": before,
          "allocated_after_init_bytes": torch.cuda.memory_allocated(),
          "init_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    params = model.params()
    launches = phase_ssm_prefill(cfg, params)
    phase_ssm_serve(cfg, params)
    del model, params
    torch.cuda.empty_cache()
    return launches


#: recurrentgemma-9b: prefill batch x prompt; serve batch, prompt, generated
RG_PREFILL_SHAPE = (8, 2048)
#: the prefill checks against the plain path (chunked scan, plain
#: attention with its [B, 16, 2048, 2048] float32 scores) run at this batch
RG_CHECK_BATCH = 2
RG_SERVE_SHAPE = (8, 128, 64)
#: float32 prefill logits, the kernel path against the plain path: the
#: same recurrence scanned in another order (the chunked path's
#: associative scan) and attention summed in another order, through 38
#: layers
RG_PREFILL_F32_TOL = 1e-3
#: the first generated token's float32 logits against the prefill's, with
#: a float32 KV cache: the same function, the prompt as 128 decode steps
#: against one full forward, through 38 layers.  With the config's bf16
#: cache the keys and values are rounded to bf16 first (2^-8 relative),
#: and the dense family's tolerance applies (SERVE_VS_PREFILL_TOL)
RG_SERVE_VS_PREFILL_TOL = 1e-3
#: the ring check: the smoke config (window 8) served through the kernels
#: for 24 steps, so its 8-slot ring wraps twice; each step's float32
#: logits against the plain step fed the same tokens (both caches bf16,
#: and equal: the one attention layer sees the same inputs in both
#: loops), to the sums' order through 4 layers
RING_STEPS, RING_PROMPT, RING_TOL = 24, 4, 1e-4
RG_PROFILE_NAMES = ("lru_scan_kernel", "flash_attention_mma_kernel",
                    "flash_attention_kernel", "decode_attention_kernel",
                    "decode_attention_fold_kernel", "nvjet", "gemm",
                    "elementwise")


def _layer_kinds(cfg) -> dict:
    """Layers of each block kind in ``cfg``'s stack."""
    from repro_torch.models.transformer import stack_plan
    kinds, n_groups, tail = stack_plan(cfg)
    return {k: kinds.count(k) * n_groups + tail.count(k)
            for k in set(kinds) | set(tail)}


def phase_hybrid_prefill(cfg, params) -> tuple[int, int]:
    """``make_prefill`` on recurrentgemma-9b at full size, batch 8 x
    2,048; returns the RG-LRU scan and flash launches of the timed (bf16)
    calls."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_prefill
    (b, s), calls = RG_PREFILL_SHAPE, 3
    layers = _layer_kinds(cfg)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    batch = {"tokens": tokens}
    prefill = make_prefill(cfg)
    prefill(params, batch)  # first call: the kernels' first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    walls = []
    for _ in range(calls):
        wall, logits = _timed(lambda: prefill(params, batch))
        walls.append(wall)
    lru = dispatch.launches["repro_lru_scan"]
    flash = dispatch.launches["repro_flash_attention"]
    require(lru == layers["rec"] * calls and flash == layers["attn"] * calls
            and sum(dispatch.launches.values()) == lru + flash,
            f"hybrid prefill: launches {dispatch.launches} over {calls} "
            "calls")
    peak = torch.cuda.max_memory_allocated()
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            "hybrid prefill: logits are not finite float32 [8, vocab]")
    prof = _profile(lambda: prefill(params, batch), RG_PROFILE_NAMES)
    del logits
    # the checks against the plain path (the chunked scan and the plain
    # attention), at batch 2
    sub = {"tokens": tokens[:RG_CHECK_BATCH]}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    kern32 = make_prefill(cfg32)(params, sub)
    plain32 = make_prefill(cfg32, attn_impl="dense")(params, sub)
    err32 = float((kern32 - plain32).abs().max())
    require(bool(torch.isfinite(kern32).all()) and err32 <= RG_PREFILL_F32_TOL,
            f"hybrid prefill float32: kernel vs plain logits differ by "
            f"{err32}")
    kern = make_prefill(cfg)(params, sub)
    plain = make_prefill(cfg, attn_impl="dense")(params, sub)
    bf16_noise = {"max_abs": float((plain - plain32).abs().max()),
                  "rms": _rms(plain - plain32)}
    err = {"max_abs": float((kern - plain).abs().max()),
           "rms": _rms(kern - plain)}
    require(err["rms"] <= bf16_noise["rms"],
            f"hybrid prefill bf16: kernel vs plain logits differ by {err}, "
            f"more than bf16 compute moves them ({bf16_noise})")
    emit({"phase": "hybrid_prefill", "arch": cfg.name,
          "layers": cfg.n_layers, "layer_kinds": layers, "batch": b,
          "prompt": s, "compute_dtype": "bfloat16",
          "lru_scan_launches_per_call": lru // calls,
          "flash_launches_per_call": flash // calls,
          "wall_s": walls, "tok_per_s": [b * s / w for w in walls],
          "peak_mem_bytes": peak, "check_batch": RG_CHECK_BATCH,
          "logits_err_vs_plain": err, "bf16_vs_f32_logits": bf16_noise,
          "f32_logits_max_abs_err_vs_plain": err32,
          "f32_tol": RG_PREFILL_F32_TOL, "profiled_call": prof})
    return lru, flash


def _first_token_logits(cfg, params, prompt, cache_dtype):
    """The logits after the serve step has taken the whole prompt (those
    of the first generated token), with a KV cache of ``cache_dtype``."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer
    b, plen = prompt.shape
    step = make_serve_step(cfg, plen, b)
    seen = {}
    step.observe = lambda dbatch, logits: seen.update(logits=logits)
    cache = transformer.init_cache(cfg, b, plen, dtype=cache_dtype)
    toks = torch.from_numpy(prompt).cuda()
    for t in range(plen):
        step(params, cache, {"tokens": toks[:, t:t + 1], "index": t})
    return seen["logits"]


def phase_hybrid_serve(cfg, params) -> int:
    """The ``launch.serve`` loop on recurrentgemma-9b at full size, batch
    8, prompt 128, gen 64: the first token's float32 logits against the
    prefill's, then the config's bf16, timed; returns the decode-attention
    launches of the bf16 run."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill, make_serve_step
    (b, plen, gen), seed = RG_SERVE_SHAPE, 0
    kv_len = plen + gen
    layers = _layer_kinds(cfg)
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab,
                                                 size=(b, plen))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        pre = make_prefill(cfg32)(params, {"tokens": prompt})
        first32 = _first_token_logits(cfg32, params, prompt, torch.float32)
        first16 = _first_token_logits(cfg32, params, prompt, torch.bfloat16)
    require(bool(torch.isfinite(first32).all()),
            "hybrid serve float32: logits not finite")
    err32 = float((first32 - pre).abs().max())
    err16 = float((first16 - pre).abs().max())
    require(err32 <= RG_SERVE_VS_PREFILL_TOL,
            f"hybrid serve float32 (float32 cache): the first generated "
            f"token's logits differ from the prefill's by {err32}")
    require(err16 <= SERVE_VS_PREFILL_TOL,
            f"hybrid serve float32 (bf16 cache): the first generated "
            f"token's logits differ from the prefill's by {err16}")
    del pre, first32, first16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = generate(cfg, params, prompt, gen)
    launches = dispatch.launches["repro_decode_attention"]
    require(launches == layers["attn"] * kv_len
            and sum(dispatch.launches.values()) == launches,
            f"hybrid serve: launches {dispatch.launches} over {kv_len} "
            "steps")
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(toks.shape == (b, gen) and toks.min() >= 0
            and toks.max() < cfg.vocab, f"hybrid serve: tokens {toks.shape}")
    step = make_serve_step(cfg, kv_len, b)
    cache = res["cache"]
    last = {"tokens": torch.from_numpy(toks[:, -1:]).cuda(),
            "index": kv_len - 1}
    prof = _profile(lambda: step(params, cache, last), RG_PROFILE_NAMES)
    _require_split_decode(prof, layers["attn"], cfg, b,
                          min(kv_len, cfg.window), "hybrid serve")
    emit({"phase": "hybrid_serve", "arch": cfg.name,
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": gen, "decode_launches_per_step": launches // kv_len,
          "prompt_steps_s": res["prompt_s"], "gen_s": res["gen_s"],
          "ms_per_decode_step": res["gen_s"] / gen * 1e3,
          "gen_tok_per_s": b * gen / res["gen_s"], "peak_mem_bytes": peak,
          "f32_first_token_logits_vs_prefill_max_abs": err32,
          "f32_first_token_vs_prefill_tol": RG_SERVE_VS_PREFILL_TOL,
          "f32_bf16_cache_first_token_vs_prefill_max_abs": err16,
          "f32_bf16_cache_first_token_vs_prefill_tol": SERVE_VS_PREFILL_TOL,
          "sample_row": toks[0][:16].tolist(), "profiled_step": prof})
    return launches


#: the configs whose smoke size (window 8) phase ``ring`` wraps
RING_ARCHS = ("recurrentgemma-9b", "starcoder2-3b")


def phase_ring() -> dict:
    """The ring-buffer KV cache on the card: recurrentgemma-9b's and
    starcoder2-3b's smoke configs (window 8) each served through the
    kernels for 24 steps, each step's float32 logits against the plain
    step fed the same tokens; returns the decode-attention launches by
    arch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer
    out = {}
    for arch in RING_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype="float32")
        b = 2
        params = transformer.init(cfg, seed=0, device="cuda").params()
        prompt = np.random.RandomState(1).randint(0, cfg.vocab,
                                                  size=(b, RING_PROMPT))
        plain_cache = transformer.init_cache(cfg, b, RING_STEPS)
        stats = {"max_err": 0.0, "steps": 0}

        def observe(dbatch, logits):
            want, _ = transformer.decode_step(params, plain_cache, dbatch,
                                              cfg, impl="dense")
            err = float((logits - want).abs().max())
            require(bool(torch.isfinite(logits).all()) and err <= RING_TOL,
                    f"ring {arch} step {dbatch['index']}: logits differ "
                    f"from the plain step by {err}")
            stats["max_err"] = max(stats["max_err"], err)
            stats["steps"] += 1

        dispatch.reset_launches()
        with torch.no_grad():
            res = generate(cfg, params, prompt, RING_STEPS - RING_PROMPT,
                           observe=observe)
        launches = dispatch.launches["repro_decode_attention"]
        attn = next(name for name in res["cache"]["groups"]
                    if name.endswith("_attn"))
        s_buf = res["cache"]["groups"][attn]["k"].shape[3]
        require(stats["steps"] == RING_STEPS and s_buf == cfg.window
                and RING_STEPS > 2 * s_buf
                and launches == _layer_kinds(cfg)["attn"] * RING_STEPS
                and sum(dispatch.launches.values()) == launches,
                f"ring {arch}: {stats['steps']} steps over {s_buf} slots, "
                f"launches {dispatch.launches}")
        emit({"phase": "ring", "arch": cfg.name + " (smoke)",
              "window": cfg.window, "cache_slots": s_buf,
              "steps": RING_STEPS, "ring_wraps": RING_STEPS // s_buf - 1,
              "logits_max_abs_err_vs_plain": stats["max_err"],
              "tol": RING_TOL, "decode_launches": launches})
        out[arch] = launches
        del params, plain_cache, res
    return out


def phase_hybrid() -> dict:
    """recurrentgemma-9b at full width and depth (38 layers, 10.44 B
    parameters, random weights from seed 0): prefill, then serving; then
    the ring check; returns the kernels' launches on these paths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api
    cfg = get_config("recurrentgemma-9b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = get_api(cfg).init(cfg, seed=0, device="cuda")
    # the reference's analytic count (ArchConfig.param_count) leaves out
    # the RG-LRU's lambda [W] of every rec layer and the final norm
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.param_count() + _layer_kinds(cfg)["rec"]
            * cfg.lru_width + cfg.d_model,
            f"recurrentgemma-9b: {n_params} parameters")
    emit({"phase": "hybrid_init", "params": n_params,
          "param_count_analytic": cfg.param_count(),
          "allocated_before_init_bytes": before,
          "allocated_after_init_bytes": torch.cuda.memory_allocated(),
          "init_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    params = model.params()
    launches = {}
    launches["repro_lru_scan"], launches["repro_flash_attention"] = \
        phase_hybrid_prefill(cfg, params)
    launches["repro_decode_attention"] = phase_hybrid_serve(cfg, params)
    del model, params
    torch.cuda.empty_cache()
    return launches


#: the MoE family at full width, the depth cut to what one card holds in
#: float32 with room to run: qwen3-moe-235b-a22b from 94 layers to 4,
#: grok-1-314b from 64 to 2 (the analytic parameter counts below: 44.8
#: and 45.8 GB)
MOE_CUTS = {"qwen3-moe-235b-a22b": (4, 11_195_678_720),
            "grok-1-314b": (2, 11_450_572_800)}
#: prefill batch x prompt; the float32 and plain-path checks run at
#: MOE_CHECK_BATCH (the plain attention's float32 scores are
#: [B, 64, 2048, 2048])
MOE_PREFILL_SHAPE = (8, 2048)
MOE_CHECK_BATCH = 2
#: serve: batch, prompt, generated tokens
MOE_SERVE_SHAPE = {"qwen3-moe-235b-a22b": (8, 128, 32),
                   "grok-1-314b": (8, 64, 16)}
#: a (token, layer) whose float32 plain-path routing differs from the
#: kernel path's must sit at a near-tie: its k-th and (k+1)-th router
#: logits this close
MOE_NEAR_TIE = 1e-4
MOE_PROFILE_NAMES = ("flash_attention_mma_kernel", "flash_attention_kernel",
                     "decode_attention_kernel",
                     "decode_attention_fold_kernel", "nvjet", "gemm",
                     "elementwise", "copy", "scan", "index", "gather",
                     "reduce")


def _routing_diff(kern: list, plain: list, batch: int,
                  near_tie: float | None) -> dict:
    """The (token, layer) pairs whose expert set in ``plain`` (each
    call's own top k, ``record_routing``'s ``own``) differs from the set
    ``kern`` routed to.  Each must sit at a near-tie: its k-th and
    (k+1)-th logits in ``plain`` within ``near_tie``, or (``None``)
    within twice the largest change of its logits between the two
    records, which a flip needs."""
    import torch
    pairs, rows, gaps = 0, None, []
    for a, b in zip(kern, plain, strict=True):
        k = a["eidx"].shape[1]
        differ = (a["own"].sort(1).values != b["own"].sort(1).values).any(1)
        top = b["logits"].sort(1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        limit = (torch.full_like(gap, near_tie) if near_tie is not None
                 else 2 * (a["logits"] - b["logits"]).abs().amax(1))
        bad = int((differ & (gap > limit)).sum())
        require(bad == 0, f"{bad} routing differences away from a near-tie")
        pairs += int(differ.sum())
        gaps += gap[differ].tolist()
        moved = differ.reshape(batch, -1).any(1)
        rows = moved if rows is None else rows | moved
    return {"pairs": pairs, "rows_with_a_pair": int(rows.sum()),
            "max_gap": max(gaps, default=None)}


def _moe_prefill(cfg, params, names: tuple, calls: int) -> int:
    """``make_prefill`` at batch 8 x 2,048 in bf16, timed; then, at
    MOE_CHECK_BATCH, the kernel path against the plain path under one
    routing (the float32 kernel path's): float32 logits to
    PREFILL_F32_TOL, bf16 logits within the bf16-vs-float32 RMS, and the
    routing each path would take itself counted; returns the flash
    launches of the timed calls."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import moe
    (b, s), layers = MOE_PREFILL_SHAPE, cfg.n_layers
    cap = moe.capacity(b * s, cfg)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    batch = {"tokens": tokens}
    prefill = make_prefill(cfg)
    with moe.record_routing() as rec:
        prefill(params, batch)   # first call: the kernels' first launches
    drop = [1.0 - float(r["keep"].float().mean()) for r in rec]
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    walls = []
    for _ in range(calls):
        wall, logits = _timed(lambda: prefill(params, batch))
        walls.append(wall)
    flash = dispatch.launches["repro_flash_attention"]
    require(flash == layers * calls
            and sum(dispatch.launches.values()) == flash,
            f"{names[1]}: launches {dispatch.launches} over {calls} calls")
    peak = torch.cuda.max_memory_allocated()
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"{names[1]}: logits are not finite float32 [8, vocab]")
    prof = _profile(lambda: prefill(params, batch), MOE_PROFILE_NAMES)
    del logits
    # the MoE layer waits for the host nowhere: one layer's moe_apply at
    # the call's shape under the sync debug mode, which raises on a sync
    layer0 = {k: v[0] for k, v in params["layers"]["b0_moe_attn"][
        "moe"].items()}
    x = torch.randn((b, s, cfg.d_model), device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply(layer0, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del x, layer0

    sub = {"tokens": tokens[:MOE_CHECK_BATCH]}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with moe.record_routing() as rec32:
        kern32 = make_prefill(cfg32)(params, sub)
    route = [r["eidx"] for r in rec32]
    out, recs = {}, {}
    for name, c, impl in (("plain32", cfg32, "dense"),
                          ("kern16", cfg, "auto"),
                          ("plain16", cfg, "dense")):
        with moe.force_routing(route), moe.record_routing() as recs[name]:
            out[name] = make_prefill(c, attn_impl=impl)(params, sub)
    err32 = float((kern32 - out["plain32"]).abs().max())
    require(bool(torch.isfinite(kern32).all()) and err32 <= PREFILL_F32_TOL,
            f"{names[1]} float32: kernel vs plain logits differ by {err32}")
    bf16_noise = {"max_abs": float((out["plain16"] - out["plain32"]).abs()
                                   .max()),
                  "rms": _rms(out["plain16"] - out["plain32"])}
    err = {"max_abs": float((out["kern16"] - out["plain16"]).abs().max()),
           "rms": _rms(out["kern16"] - out["plain16"])}
    require(err["rms"] <= bf16_noise["rms"],
            f"{names[1]} bf16: kernel vs plain logits differ by {err}, more "
            f"than bf16 compute moves them ({bf16_noise})")
    routing = {"float32": _routing_diff(rec32, recs["plain32"],
                                        MOE_CHECK_BATCH, MOE_NEAR_TIE),
               "bfloat16": _routing_diff(recs["kern16"], recs["plain16"],
                                         MOE_CHECK_BATCH, None)}
    emit({"phase": names[1], "arch": cfg.name, "layers": layers,
          "batch": b, "prompt": s, "compute_dtype": "bfloat16",
          "experts": cfg.n_experts, "top_k": cfg.top_k, "capacity": cap,
          "assignments": b * s * cfg.top_k,
          "dropped_share_per_layer": drop,
          "flash_launches_per_call": flash // calls, "wall_s": walls,
          "tok_per_s": [b * s / w for w in walls], "peak_mem_bytes": peak,
          "no_host_sync_in_moe_apply": True,
          "check_batch": MOE_CHECK_BATCH,
          "checks_under_the_f32_kernel_paths_routing": True,
          "f32_logits_max_abs_err_vs_plain": err32,
          "f32_tol": PREFILL_F32_TOL, "logits_err_vs_plain": err,
          "bf16_vs_f32_logits": bf16_noise,
          "routing_pairs_differing": routing, "near_tie": MOE_NEAR_TIE,
          "profiled_call": prof})
    return flash


def _moe_serve(cfg, params, name: str) -> int:
    """The ``launch.serve`` loop: in float32 each step against the plain
    step fed the same tokens, under the kernel step's routing; then the
    config's bf16, timed; returns the decode launches of the bf16 run."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import moe, transformer
    (b, plen, gen), layers = MOE_SERVE_SHAPE[cfg.name], cfg.n_layers
    kv_len = plen + gen
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, size=(b, plen))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain_cache = transformer.init_cache(cfg32, b, kv_len)
    stats = {"max_err": 0.0, "near_ties": 0, "steps": 0, "pairs": 0,
             "max_gap": None}
    with moe.record_routing() as krec:
        def observe(dbatch, logits):
            kern = krec[-layers:]
            with moe.force_routing([r["eidx"] for r in kern]), \
                    moe.record_routing() as prec:
                want, _ = transformer.decode_step(params, plain_cache, dbatch,
                                                  cfg32, impl="dense")
            diff = _routing_diff(kern, prec, b, None)
            krec.clear()
            err = float((logits - want).abs().max())
            require(bool(torch.isfinite(logits).all())
                    and err <= SERVE_F32_TOL,
                    f"{name} float32 step {dbatch['index']}: logits differ "
                    f"from the plain step by {err}")
            top2 = want.topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) <= SERVE_F32_TOL
            differ = logits.argmax(-1) != want.argmax(-1)
            require(not bool((differ & ~tie).any()),
                    f"{name} float32 step {dbatch['index']}: a greedy token "
                    "differs from the plain step's away from a near-tie")
            stats["max_err"] = max(stats["max_err"], err)
            stats["near_ties"] += int((differ & tie).sum())
            stats["steps"] += 1
            stats["pairs"] += diff["pairs"]
            if diff["max_gap"] is not None:
                stats["max_gap"] = max(stats["max_gap"] or 0.0,
                                       diff["max_gap"])

        with torch.no_grad():
            res32 = generate(cfg32, params, prompt, gen, observe=observe)
    require(stats["steps"] == kv_len
            and res32["tokens"].shape == (b, gen),
            f"{name} float32: {stats['steps']} steps observed")
    del plain_cache, res32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = generate(cfg, params, prompt, gen)
    launches = dispatch.launches["repro_decode_attention"]
    require(launches == layers * kv_len
            and sum(dispatch.launches.values()) == launches,
            f"{name}: launches {dispatch.launches} over {kv_len} steps")
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(toks.shape == (b, gen) and toks.min() >= 0
            and toks.max() < cfg.vocab, f"{name}: tokens {toks.shape}")
    step = make_serve_step(cfg, kv_len, b)
    cache = res["cache"]
    last = {"tokens": torch.from_numpy(toks[:, -1:]).cuda(),
            "index": kv_len - 1}
    prof = _profile(lambda: step(params, cache, last), MOE_PROFILE_NAMES)
    _require_split_decode(prof, layers, cfg, b, kv_len, name)
    # what a step spends casting the expert stacks to bf16, as the
    # reference does on every step: the three stacks of every layer
    experts = params["layers"]["b0_moe_attn"]["moe"]

    def cast():
        for w in ("w_gate", "w_up", "w_down"):
            experts[w].to(torch.bfloat16)
    emit({"phase": name, "arch": cfg.name, "layers": layers,
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": gen, "decode_launches_per_step": launches // kv_len,
          "prompt_steps_s": res["prompt_s"], "gen_s": res["gen_s"],
          "ms_per_decode_step": res["gen_s"] / gen * 1e3,
          "gen_tok_per_s": b * gen / res["gen_s"], "peak_mem_bytes": peak,
          "expert_cast_ms_per_step": cuda_ms(cast, 3),
          "f32_check": {"steps": stats["steps"],
                        "logits_max_abs_err_vs_plain": stats["max_err"],
                        "tol": SERVE_F32_TOL,
                        "greedy_tokens_differing_at_near_ties":
                            stats["near_ties"],
                        "routing_pairs_differing": stats["pairs"],
                        "routing_max_gap": stats["max_gap"]},
          "sample_row": toks[0][:16].tolist(), "profiled_step": prof})
    del res, cache
    return launches


def phase_moe() -> dict:
    """qwen3-moe-235b-a22b (4 of 94 layers) and grok-1-314b (2 of 64) at
    full width, random weights from seed 0: init, prefill, serving;
    returns the attention kernels' launches on these paths."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api
    launches = {"repro_flash_attention": 0, "repro_decode_attention": 0}
    for arch, names, calls in (
            ("qwen3-moe-235b-a22b", ("moe_init", "moe_prefill", "moe_serve"),
             3),
            ("grok-1-314b", ("grok_moe_init", "grok_moe_prefill",
                             "grok_moe_serve"), 2)):
        full = get_config(arch)
        layers, want = MOE_CUTS[arch]
        cfg = dataclasses.replace(full, n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = get_api(cfg).init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the reference's analytic count leaves out the final norm
        n_params = sum(p.numel() for p in model.parameters())
        require(cfg.param_count() == want
                and n_params == cfg.param_count() + cfg.d_model,
                f"{arch}: {n_params} parameters, {cfg.param_count()} "
                "analytic")
        emit({"phase": names[0], "arch": arch,
              "cut": f"depth {full.n_layers} -> {layers} layers, full width",
              "params": n_params, "param_count_analytic": cfg.param_count(),
              "param_bytes": 4 * n_params, "init_s": init_s,
              "allocated_before_init_bytes": before,
              "init_peak_mem_bytes": torch.cuda.max_memory_allocated()})
        params = model.params()
        launches["repro_flash_attention"] += _moe_prefill(cfg, params,
                                                          names, calls)
        launches["repro_decode_attention"] += _moe_serve(cfg, params,
                                                         names[2])
        del model, params
        torch.cuda.empty_cache()
    return launches


#: the hybrid's training on the card: recurrentgemma-9b at full width,
#: the depth cut to one (rec, rec, attn) group and its 2-layer tail
HYBRID_TRAIN_STEPS = 3
HYBRID_TRAIN_SHAPE = (8, 128)


def phase_hybrid_train() -> dict:
    """recurrentgemma-9b cut to 5 layers, through the trainer's layout
    rule (MPC-FSDP at one party), 3 steps on the chunked scan under
    autograd; returns the share and reconstruct launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, n_layers=5, n_tail_layers=2)
    b, s = HYBRID_TRAIN_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, device="cuda")
    require(step.fsdp, "hybrid_train: the layout rule did not pick MPC-FSDP")
    model = step.shard_model(transformer.init(cfg, seed=0, device="cuda"))
    opt = adamw_init(model.params())
    per_step: list = []

    def observe(grads, agg):
        per_step.append({k: v for k, v in dispatch.launches.items() if v})
        dispatch.reset_launches()

    step.observe = observe
    losses, walls = [], []
    dispatch.reset_launches()
    for i in range(HYBRID_TRAIN_STEPS):
        toks, labels = lm_batch(cfg.vocab, b, s, seed=0, party=0, step=i)
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, i,
                                {"tokens": toks, "labels": labels})
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), f"hybrid_train: {losses}")
    require(len(per_step) == HYBRID_TRAIN_STEPS and all(
        c.get("repro_share_gen", 0) > 0 and c.get("repro_reconstruct", 0) > 0
        and not any(k in c for k in ("repro_flash_attention",
                                     "repro_lru_scan"))
        for c in per_step), f"hybrid_train: launches per step {per_step}")
    split = sum(d is not None for d in step.dims.values())
    emit({"phase": "hybrid_train", "arch": cfg.name,
          "cut": f"depth {full.n_layers} -> {cfg.n_layers} layers (one "
                 "rec, rec, attn group and the 2-layer tail), full width",
          "params": cfg.param_count(), "layout": "mpc_fsdp", "parties": 1,
          "batch": b, "seq": s, "split_leaves": split,
          "whole_leaves": len(step.dims) - split, "losses": losses,
          "step_wall_s": walls, "tok_per_s": [b * s / w for w in walls],
          "launches_per_step": per_step, "peak_mem_bytes": peak})
    launches = {k: sum(c.get(k, 0) for c in per_step)
                for k in ("repro_share_gen", "repro_reconstruct")}
    del model, opt, step
    torch.cuda.empty_cache()
    return launches


#: whisper-large-v3 (32 + 32 layers): prefill batch, decoder tokens (its
#: 448-token context) against the config's 1,500 frames; serve batch,
#: prompt, generated tokens
ENCDEC_PREFILL_SHAPE = (8, 448)
ENCDEC_SERVE_SHAPE = (8, 64, 64)
#: qwen2-vl-2b (28 layers): prefill batch x embeds; serve batch, prompt
#: steps, generated tokens, every step fed seeded random embeds
VLM_PREFILL_SHAPE = (8, 2048)
VLM_SERVE_SHAPE = (8, 128, 64)
#: starcoder2-3b (30 layers): prefill batch x prompt, so that its window
#: of 4,096 binds; serve batch, prompt, generated tokens
WINDOW_PREFILL_SHAPE = (2, 16384)
WINDOW_SERVE_SHAPE = (8, 128, 64)
#: qwen2-vl-2b's and starcoder2-3b's float32 serve checks run the first
#: prompt and generated steps of these (whisper's runs the whole loop):
#: the script's time limit, and a 192-step cache that neither ring nor
#: window reaches at full size
VARIANT_F32_CHECK_STEPS = (32, 32)
#: the prefill checks against the plain path run at this (batch, length):
#: the plain attention materializes float32 scores ([1, 24, 8192^2]:
#: 6.4 GB a layer for starcoder2-3b); whisper's at batch 2 of its shape
DENSE_VARIANT_CHECK = {"whisper-large-v3": (2, 448),
                       "qwen2-vl-2b": (2, 2048),
                       "starcoder2-3b": (1, 8192)}
VARIANT_PROFILE_NAMES = ("flash_attention_mma_kernel",
                         "flash_attention_kernel", "decode_attention_kernel",
                         "decode_attention_fold_kernel", "nvjet", "gemm",
                         "elementwise", "copy", "reduce")


def _prefill_checks(cfg, params, sub, what: str) -> dict:
    """The kernel path against the plain path on ``sub``: float32 logits
    to PREFILL_F32_TOL, bf16 logits within the bf16-vs-float32 RMS."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import make_prefill
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    kern32 = make_prefill(cfg32)(params, sub)
    plain32 = make_prefill(cfg32, attn_impl="dense")(params, sub)
    err32 = float((kern32 - plain32).abs().max())
    require(bool(torch.isfinite(kern32).all()) and err32 <= PREFILL_F32_TOL,
            f"{what} float32: kernel vs plain logits differ by {err32}")
    del kern32
    torch.cuda.empty_cache()
    kern = make_prefill(cfg)(params, sub)
    plain = make_prefill(cfg, attn_impl="dense")(params, sub)
    bf16_noise = {"max_abs": float((plain - plain32).abs().max()),
                  "rms": _rms(plain - plain32)}
    err = {"max_abs": float((kern - plain).abs().max()),
           "rms": _rms(kern - plain)}
    require(err["rms"] <= bf16_noise["rms"],
            f"{what} bf16: kernel vs plain logits differ by {err}, more "
            f"than bf16 compute moves them ({bf16_noise})")
    torch.cuda.empty_cache()
    return {"f32_logits_max_abs_err_vs_plain": err32,
            "f32_tol": PREFILL_F32_TOL, "logits_err_vs_plain": err,
            "bf16_vs_f32_logits": bf16_noise}


def _variant_prefill(cfg, params, batch, calls: int, what: str) -> dict:
    """``make_prefill`` on ``batch`` in the config's bf16, timed over
    ``calls`` calls with its flash launches (and no other kernel's), and
    one profiled call."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_prefill
    prefill = make_prefill(cfg)
    prefill(params, batch)  # first call: the kernels' first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    walls = []
    for _ in range(calls):
        wall, logits = _timed(lambda: prefill(params, batch))
        walls.append(wall)
    flash = dispatch.launches["repro_flash_attention"]
    require(flash > 0 and sum(dispatch.launches.values()) == flash,
            f"{what}: launches {dispatch.launches} over {calls} calls")
    peak = torch.cuda.max_memory_allocated()
    b = logits.shape[0]
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"{what}: logits are not finite float32 [{b}, vocab]")
    del logits
    prof = _profile(lambda: prefill(params, batch), VARIANT_PROFILE_NAMES)
    torch.cuda.empty_cache()
    return {"flash_launches": flash, "wall_s": walls, "peak_mem_bytes": peak,
            "profiled_call": prof}


def _variant_serve_check(cfg32, params, prompt, gen: int, plain_cache,
                         what: str, **inputs) -> dict:
    """The ``launch.serve`` loop in float32 compute: each step's logits
    against the plain step (``impl="dense"``, a cache of its own) fed the
    same inputs, to SERVE_F32_TOL; greedy tokens equal except at
    near-ties."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models.registry import get_api
    api = get_api(cfg32)
    stats = {"max_err": 0.0, "near_ties": 0, "steps": 0}

    def observe(dbatch, logits):
        want, _ = api.decode_step(params, plain_cache, dbatch, cfg32,
                                  impl="dense")
        err = float((logits - want).abs().max())
        require(bool(torch.isfinite(logits).all()) and err <= SERVE_F32_TOL,
                f"{what} float32 step {dbatch['index']}: logits differ from "
                f"the plain step by {err}")
        top2 = want.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= SERVE_F32_TOL
        differ = logits.argmax(-1) != want.argmax(-1)
        require(not bool((differ & ~tie).any()),
                f"{what} float32 step {dbatch['index']}: a greedy token "
                "differs from the plain step's away from a near-tie")
        stats["max_err"] = max(stats["max_err"], err)
        stats["near_ties"] += int((differ & tie).sum())
        stats["steps"] += 1

    with torch.no_grad():
        res = generate(cfg32, params, prompt, gen, observe=observe, **inputs)
    b, plen = prompt.shape
    require(stats["steps"] == plen + gen
            and res["tokens"].shape == (b, gen),
            f"{what} float32: {stats['steps']} steps observed")
    return {"steps": stats["steps"],
            "logits_max_abs_err_vs_plain": stats["max_err"],
            "tol": SERVE_F32_TOL,
            "greedy_tokens_differing_at_near_ties": stats["near_ties"]}


def _variant_serve(cfg, params, prompt, gen: int, what: str,
                   **inputs) -> dict:
    """The ``launch.serve`` loop in the config's bf16, timed, with its
    decode launches (and no other kernel's) and one profiled step, whose
    split-kernel and fold launches must be the plan's."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention.kernel import split_plan
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    b, plen = prompt.shape
    kv_len = plen + gen
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = generate(cfg, params, prompt, gen, **inputs)
    launches = dispatch.launches["repro_decode_attention"]
    per_step = (2 if cfg.enc_dec else 1) * cfg.n_layers
    require(launches == per_step * kv_len
            and sum(dispatch.launches.values()) == launches,
            f"{what}: launches {dispatch.launches} over {kv_len} steps")
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    require(toks.shape == (b, gen) and toks.min() >= 0
            and toks.max() < cfg.vocab, f"{what}: tokens {toks.shape}")
    step = make_serve_step(cfg, kv_len, b)
    cache = res["cache"]
    last = {"tokens": torch.from_numpy(toks[:, -1:]).cuda(),
            "index": kv_len - 1}
    if cfg.frontend == "embeddings":
        last = {"embeds": inputs["embeds"][:, -1:], "index": kv_len - 1}
    dispatch.reset_launches()
    prof = _profile(lambda: step(params, cache, last), VARIANT_PROFILE_NAMES)
    # the self-attention's plan at the last step (and the cross-attention's
    # at every encoder key), each layer once: the step launched the split
    # kernel once a layer, and the trace shows the fold where a plan has
    # several splits and nowhere else.  Late in a long run the tracer
    # drops a few kernel records (on an H100: one decode launch of a
    # step's 64 missing from its trace while the wrappers counted 64), so
    # the traced counts may fall short of the launches, never above them
    group = cfg.n_heads // cfg.n_kv_heads
    plans = [split_plan(b, cfg.n_kv_heads, min(kv_len, cfg.window or kv_len),
                        group)[0]]
    if cfg.enc_dec:
        plans.append(split_plan(b, cfg.n_heads, cfg.enc_seq, 1)[0])
    want = {"decode_attention_kernel": cfg.n_layers * len(plans),
            "decode_attention_fold_kernel":
                cfg.n_layers * sum(p > 1 for p in plans)}
    got = {n: prof["kernel_launches"][n] for n in want}
    require(dispatch.launches["repro_decode_attention"]
            == want["decode_attention_kernel"]
            and all(got[n] <= want[n] for n in want)
            and (got["decode_attention_fold_kernel"] > 0)
            == (want["decode_attention_fold_kernel"] > 0),
            f"{what}: the profiled step launched "
            f"{dispatch.launches['repro_decode_attention']}, traced {got}, "
            f"expected {want} (splits {plans})")
    # what a step spends casting the embedding table to bf16, as the
    # reference does on every step: once to gather the step's rows, and
    # once more for a tied head (whisper-large-v3, qwen2-vl-2b)
    table = params["embed"]["table"]
    out = {"decode_launches_per_step": launches // kv_len,
           "decode_launches": launches, "splits": plans,
           "traced_launches_missing": {n: want[n] - got[n] for n in want},
           "table_cast_ms": cuda_ms(lambda: table.to(torch.bfloat16), 5),
           "table_casts_per_step": 2 if cfg.tie_embeddings else 1,
           "prompt_steps_s": res["prompt_s"], "gen_s": res["gen_s"],
           "ms_per_decode_step": res["gen_s"] / gen * 1e3,
           "gen_tok_per_s": b * gen / res["gen_s"], "peak_mem_bytes": peak,
           "sample_row": toks[0][:16].tolist(), "profiled_step": prof}
    del res, cache
    return out


def _variant_init(arch: str, phase: str):
    """``arch`` at full width and depth from seed 0; emits its parameter
    counts and init time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = get_api(cfg).init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit({"phase": phase, "arch": arch, "layers": cfg.n_layers,
          "enc_layers": cfg.n_enc_layers, "params": n_params,
          "param_count_analytic": cfg.param_count(),
          "param_bytes": 4 * n_params, "init_s": time.perf_counter() - t0,
          "allocated_before_init_bytes": before,
          "init_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return cfg, model


def phase_encdec() -> dict:
    """whisper-large-v3 at full width and depth (32 encoder and 32 decoder
    layers, random weights from seed 0): prefill at batch 8 over
    [8, 1500, 1280] frames and 448 decoder tokens, then serving from the
    cross K/V of the encoded frames; returns the attention kernels'
    launches on this path."""
    import dataclasses
    import torch
    from repro_torch.models import encdec
    cfg, model = _variant_init("whisper-large-v3", "encdec_init")
    params = model.params()
    (b, s), calls = ENCDEC_PREFILL_SHAPE, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn((b, cfg.enc_seq, cfg.d_model), device="cuda",
                         generator=gen).to(torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    batch = {"frames": frames, "tokens": tokens}
    pre = _variant_prefill(cfg, params, batch, calls, "encdec_prefill")
    want = 3 * cfg.n_layers * calls  # encoder, self- and cross-attention
    require(pre["flash_launches"] == want,
            f"encdec_prefill: {pre['flash_launches']} flash launches, "
            f"expected {want}")
    cb, _ = DENSE_VARIANT_CHECK[cfg.name]
    checks = _prefill_checks(cfg, params, {"frames": frames[:cb],
                                           "tokens": tokens[:cb]},
                             "encdec_prefill")
    emit({"phase": "encdec_prefill", "arch": cfg.name,
          "layers": [cfg.n_enc_layers, cfg.n_layers], "batch": b,
          "frames": cfg.enc_seq, "tokens": s, "compute_dtype": "bfloat16",
          "flash_launches_per_call": pre["flash_launches"] // calls,
          "wall_s": pre["wall_s"],
          "tok_per_s": [b * s / w for w in pre["wall_s"]],
          "frames_per_s": [b * cfg.enc_seq / w for w in pre["wall_s"]],
          "peak_mem_bytes": pre["peak_mem_bytes"], "check_batch": cb,
          **checks, "profiled_call": pre["profiled_call"]})

    (b, plen, n_gen) = ENCDEC_SERVE_SHAPE
    kv_len = plen + n_gen
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, size=(b, plen))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        enc32 = encdec.encode(params, frames[:b], cfg32)
        plain_cache = encdec.init_cache(params, cfg32, b, kv_len,
                                        enc_out=enc32)
        check = _variant_serve_check(cfg32, params, prompt, n_gen,
                                     plain_cache, "encdec_serve",
                                     enc_out=enc32)
        del enc32, plain_cache
        enc16 = encdec.encode(params, frames[:b], cfg)
    serve = _variant_serve(cfg, params, prompt, n_gen, "encdec_serve",
                           enc_out=enc16)
    emit({"phase": "encdec_serve", "arch": cfg.name,
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": n_gen, "cross_keys": cfg.enc_seq,
          "cache": "cross K/V of the encoded frames", **serve,
          "f32_check": check})
    del model, params, frames, enc16
    torch.cuda.empty_cache()
    return {"repro_flash_attention": pre["flash_launches"],
            "repro_decode_attention": serve["decode_launches"]}


def phase_vlm() -> dict:
    """qwen2-vl-2b at full width and depth (28 layers, random weights
    from seed 0), fed seeded random embeds: prefill at batch 8 x 2,048,
    then serving, 128 prompt steps and 64 generated; returns the
    attention kernels' launches on this path."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    cfg, model = _variant_init("qwen2-vl-2b", "vlm_init")
    params = model.params()
    (b, s), calls = VLM_PREFILL_SHAPE, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    embeds = torch.randn((b, s, cfg.d_model), device="cuda",
                         generator=gen).to(torch.bfloat16)
    pre = _variant_prefill(cfg, params, {"embeds": embeds}, calls,
                           "vlm_prefill")
    require(pre["flash_launches"] == cfg.n_layers * calls,
            f"vlm_prefill: {pre['flash_launches']} flash launches")
    cb, cs = DENSE_VARIANT_CHECK[cfg.name]
    checks = _prefill_checks(cfg, params, {"embeds": embeds[:cb, :cs]},
                             "vlm_prefill")
    emit({"phase": "vlm_prefill", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": b, "prompt": s, "compute_dtype": "bfloat16",
          "flash_launches_per_call": pre["flash_launches"] // calls,
          "wall_s": pre["wall_s"],
          "tok_per_s": [b * s / w for w in pre["wall_s"]],
          "peak_mem_bytes": pre["peak_mem_bytes"], "check_batch": cb,
          **checks, "profiled_call": pre["profiled_call"]})
    del embeds

    (b, plen, n_gen) = VLM_SERVE_SHAPE
    kv_len = plen + n_gen
    prompt = np.zeros((b, plen), np.int64)  # not read: embeds are fed
    step_embeds = torch.randn((b, kv_len, cfg.d_model), device="cuda",
                              generator=gen).to(torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cp, cg = VARIANT_F32_CHECK_STEPS
    check = _variant_serve_check(
        cfg32, params, prompt[:, :cp], cg, transformer.init_cache(
            cfg32, b, cp + cg), "vlm_serve", embeds=step_embeds)
    serve = _variant_serve(cfg, params, prompt, n_gen, "vlm_serve",
                           embeds=step_embeds)
    emit({"phase": "vlm_serve", "arch": cfg.name,
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": n_gen, "inputs": "seeded random embeds every step",
          **serve, "f32_check": check})
    del model, params, step_embeds
    torch.cuda.empty_cache()
    return {"repro_flash_attention": pre["flash_launches"],
            "repro_decode_attention": serve["decode_launches"]}


def phase_window() -> dict:
    """starcoder2-3b at full width and depth (30 layers, random weights
    from seed 0): prefill at 2 x 16,384 in bf16, where its window of
    4,096 binds, then serving at batch 8; returns the attention kernels'
    launches on this path."""
    import dataclasses
    import torch
    from repro_torch.models import transformer
    cfg, model = _variant_init("starcoder2-3b", "window_init")
    params = model.params()
    (b, s), calls = WINDOW_PREFILL_SHAPE, 2
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(b, s))).cuda()
    pre = _variant_prefill(cfg, params, {"tokens": tokens}, calls,
                           "window_prefill")
    require(pre["flash_launches"] == cfg.n_layers * calls,
            f"window_prefill: {pre['flash_launches']} flash launches")
    cb, cs = DENSE_VARIANT_CHECK[cfg.name]
    checks = _prefill_checks(cfg, params, {"tokens": tokens[:cb, :cs]},
                             "window_prefill")
    emit({"phase": "window_prefill", "arch": cfg.name,
          "layers": cfg.n_layers, "window": cfg.window, "batch": b,
          "prompt": s, "compute_dtype": "bfloat16",
          "flash_launches_per_call": pre["flash_launches"] // calls,
          "wall_s": pre["wall_s"],
          "tok_per_s": [b * s / w for w in pre["wall_s"]],
          "peak_mem_bytes": pre["peak_mem_bytes"],
          "check_shape": [cb, cs], **checks,
          "profiled_call": pre["profiled_call"]})

    (b, plen, n_gen) = WINDOW_SERVE_SHAPE
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, size=(b, plen))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cp, cg = VARIANT_F32_CHECK_STEPS
    check = _variant_serve_check(
        cfg32, params, prompt[:, :cp], cg, transformer.init_cache(
            cfg32, b, cp + cg), "window_serve")
    serve = _variant_serve(cfg, params, prompt, n_gen, "window_serve")
    emit({"phase": "window_serve", "arch": cfg.name,
          "compute_dtype": "bfloat16", "batch": b, "prompt": plen,
          "gen": n_gen, **serve, "f32_check": check})
    del model, params, tokens
    torch.cuda.empty_cache()
    return {"repro_flash_attention": pre["flash_launches"],
            "repro_decode_attention": serve["decode_launches"]}


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
    ("flash_attention", "repro_flash_attention",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:104"),
    ("decode_attention", "repro_decode_attention",
     "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:72"),
    ("ssm_scan", "repro_ssm_scan",
     "src/repro_torch/kernels/csrc/ssm_scan.cu",
     "src/repro/kernels/ssm_scan/kernel.py:55"),
    ("lru_scan", "repro_lru_scan",
     "src/repro_torch/kernels/csrc/lru_scan.cu",
     "src/repro/kernels/lru_scan/kernel.py:42"),
]
#: the kernel-line keys of a timing row
ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


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
    phase_attention_ptxas()
    flash_rows = phase_flash_kernel()
    decode_rows = phase_decode_kernel()
    # the kernels line reports each attention kernel at the dense family's
    # shape and, under "d256", at recurrentgemma-9b's, each with its own
    # path's launches
    attn_rows = {"flash_attention": flash_rows["prefill"],
                 "decode_attention": decode_rows["qwen"],
                 "ssm_scan": phase_ssm_kernel(),
                 "lru_scan": phase_lru_kernel()}
    d256_rows = {"flash_attention": flash_rows["rg_prefill"],
                 "decode_attention": decode_rows["rg"]}
    # and under "moe" at qwen3-moe-235b-a22b's shapes (grok-1-314b's
    # beside them), with the MoE paths' launches
    moe_rows = {"flash_attention": (flash_rows["moe_prefill"],
                                    flash_rows["grok_prefill"]),
                "decode_attention": (decode_rows["moe"], decode_rows["grok"])}
    # and under "encdec", "vlm" and "window" at whisper-large-v3's,
    # qwen2-vl-2b's and starcoder2-3b's main-path shapes (the first row
    # of each, the path's other shapes beside it), with their launches
    variant_rows = {
        "encdec": {"flash_attention": (flash_rows["whisper_enc"], {
            "self": flash_rows["whisper_dec"],
            "cross": flash_rows["whisper_cross"]}),
            "decode_attention": (decode_rows["whisper_cross"], {
                "self": decode_rows["whisper_self"]})},
        "vlm": {"flash_attention": (flash_rows["vlm_prefill"], {}),
                "decode_attention": (decode_rows["vlm"], {})},
        "window": {"flash_attention": (flash_rows["sc2_prefill"], {}),
                   "decode_attention": (decode_rows["sc2"], {
                       "full_window": decode_rows["sc2_window"]})}}
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
    for key, count in phase_topk().items():
        launches[key] = launches.get(key, 0) + count
    # the wire's launches are the party workers', read from their logs
    for phase in (phase_cohort, phase_scenarios, phase_wire):
        for key, count in phase().items():
            launches[key] = launches.get(key, 0) + count
    phase_streaming()
    phase_fedavg()
    rows.update(phase_single_kernels())
    phase_spmd()
    # the train path also decodes through the slice-1 reconstructions:
    # their launches are the rounds' and the train steps' together
    # and so do the top-k steps and the MPC-FSDP steps' backward (the
    # single-party share and ring reconstruct kernels)
    for phase in (phase_train, phase_train_topk, phase_fsdp):
        for key, count in phase().items():
            launches[key] = launches.get(key, 0) + count
    phase_ckpt()
    launches["repro_flash_attention"] = phase_prefill()
    launches["repro_decode_attention"] = phase_serve()
    launches["repro_ssm_scan"] = phase_ssm()
    # the attention kernels' launches are each path's own: the dense
    # family's at the top level, recurrentgemma-9b's under "d256"
    hybrid_launches = phase_hybrid()
    launches["repro_lru_scan"] = hybrid_launches["repro_lru_scan"]
    moe_launches = phase_moe()
    # the hybrid's training drives the MPC-FSDP share and reconstruct
    # kernels, as the train phases do
    for key, count in phase_hybrid_train().items():
        launches[key] = launches.get(key, 0) + count
    variant_launches = {"encdec": phase_encdec(), "vlm": phase_vlm(),
                        "window": phase_window()}
    phase_ring()
    rows.update(attn_rows)

    kernels = []
    for name, key, source, replaces in KERNELS:
        row = rows[name]
        require(launches.get(key, 0) > 0,
                f"{name} was not launched on the main path")
        # SDPA for the attention kernels; no single PyTorch call computes
        # the others (a selective or linear scan included)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[key],
                 **{k: row.get(k) for k in ROW_KEYS}}
        if name in d256_rows:
            entry["d256"] = {"shape": d256_rows[name]["shape"],
                             "launches": hybrid_launches[key],
                             **{k: d256_rows[name].get(k)
                                for k in ROW_KEYS}}
        if name in moe_rows:
            require(moe_launches[key] > 0,
                    f"{name} was not launched on the MoE path")
            qwen3, grok = moe_rows[name]
            entry["moe"] = {"shape": qwen3["shape"],
                            "launches": moe_launches[key],
                            "graph_ms": qwen3.get("graph_ms"),
                            **{k: qwen3.get(k) for k in ROW_KEYS},
                            "grok": {"shape": grok["shape"],
                                     "graph_ms": grok.get("graph_ms"),
                                     **{k: grok.get(k) for k in ROW_KEYS}}}
        for path, by_kernel in variant_rows.items():
            if name not in by_kernel:
                continue
            count = variant_launches[path][key]
            require(count > 0, f"{name} was not launched on the {path} path")
            first, others = by_kernel[name]
            entry[path] = {"shape": first["shape"], "launches": count,
                           "graph_ms": first.get("graph_ms"),
                           **{k: first.get(k) for k in ROW_KEYS},
                           **{other: {"shape": row["shape"],
                                      "graph_ms": row.get("graph_ms"),
                                      **{k: row.get(k) for k in ROW_KEYS}}
                              for other, row in others.items()}}
        kernels.append(entry)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
