"""Party worker process: one federated party over a real socket.

Counterpart of ``repro/net/party.py``, with the party's math on its own
device.  Runs as its own OS process (``python -m repro_torch.net.party
--host H --port P --party-id I [--device cuda|cpu]``; the card unless
the CPU is asked for, and no fallback: without a card ``--device cuda``
raises), connects to the coordinator, receives the
federation config in WELCOME, and then speaks the paper's protocol:

* **Phase I (Alg. 2)** — draw a ``b``-vector of votes from its own
  Philox stream, secret-share it to every peer (relayed), sum received
  shares, exchange partial sums, tally, and report the committee it
  computed — every party must arrive at the same committee or the
  coordinator raises a conformance error.
* **Phase II (Alg. 3)** — encode its flat update to fixed point, split
  it into ``m`` shares chunk-by-chunk (``chunk_elems`` elements at a
  time through ``SecureAggregator.make_shares_batch`` with
  ``elem_base`` — the streaming invariant keeps the Philox counters
  bit-identical to the whole-vector path), and upload share ``w`` to
  committee member ``w``.  Committee members fold completed uploads,
  chain partial sums (additive) or send their sum row to the last live
  member (Shamir), and the final member reconstructs + decodes the
  FedAvg mean and returns it for broadcast.

The share math is the *same* ``SecureAggregator`` the simulation uses,
with the same ``(seed, party, round)`` stream derivation — which is
why a wire round is bit-identical to ``TwoPhaseTransport`` in-sim
(pinned by ``tests/test_torch_wire.py``).  On the card the shares,
commitments, member folds, Feldman checks and the reconstruction run
there: the INPUT frame moves to the device once, each ``[m, chunk]``
share stack comes back to the host once to be framed, and received
rows go to the device to be folded, verified and reconstructed.  Frames
stay the reference's, so a worker of either package joins a round that
either package's coordinator runs.  After every round the worker writes
one JSON line to its ``--log-file``: the round, the device's name and
the kernel launches of that round (``kernels.dispatch.launches``) —
nothing of it travels on the wire.

Malicious security (``cfg.vss`` — DESIGN.md §10): dealers additionally
broadcast Feldman commitments to their round polynomial (COMMITMENT
frames, chunked on the same element boundaries as the share stream),
members batch-verify every included dealer's share against its
commitments *before* folding the member sum, and the final member
verifies every partial-sum row against the aggregate commitments
before reconstructing — a row that fails is excluded and its member
reported in a BLAME frame, so a tampering member is caught instead of
corrupting the round.

Test hooks: ``--die-after-upload R`` makes the process exit abruptly
(``os._exit``) right after sending its round-``R`` share uploads —
before its member READY — which is how the dropout tests kill a
committee member mid-Phase-II deterministically (the coordinator sees
EOF, no wall-clock races).  ``--die-before-upload R`` exits right
after decoding round ``R``'s ROUND_START, before any share frame — the
party never reaches its home member's region listener, which is the
one dropout the tree relay can only settle through the coordinator's
UPLOAD_PROBE fail-fast (DESIGN.md §13).  ``--tamper MODE
--tamper-round R`` makes a *committee member* corrupt its round-``R``
partial sum (``flip`` = bit-flipped row, ``wrong_poly`` = a row from a
polynomial nobody committed to, ``replay`` = its round ``R-1`` row) —
the adversary of the VSS battery.
Under ``relay="tree"`` the flip/replay modes corrupt the member's
*outgoing* REGION_SUMs instead, so the receivers' commitment check
(not the final member's) is what draws blame onto the sender.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.core import committee as committee_mod
from repro_torch.core import philox
from repro_torch.core import vss
from repro_torch.core.additive import share as additive_share
from repro_torch.core.field import MERSENNE_P, U32_MASK, to_field
# the sim and the wire inject the same adversary: single definition of
# the corruption constants in fl.faults
from repro_torch.fl.faults import (DEALER_TAMPER_MODES, POISON_SCALE,
                                   TAMPER_FLIP_MASK, TAMPER_MODES,
                                   TAMPER_SEED_XOR, update_norm)
from repro_torch.kernels import dispatch
from repro_torch.kernels.verify_shares import verify_shares

from . import codec
from .config import WireConfig
from .messages import MessageAssembler
from .region import RegionIngest
from .wire import (Frame, MsgType, Phase, ProtocolError, Scheme,
                   StaleSessionError, TruncatedFrameError, WireError,
                   Wiredtype, read_frame, write_frame)

__all__ = ["PartyWorker", "main"]


class _Shutdown(Exception):
    """Coordinator asked us to exit (clean)."""


class _RegionDead(Exception):
    """The party's home member became unreachable mid-upload (tree
    relay).  Not fatal to the party: it abandons the round's upload —
    the coordinator degrades the whole region to the sub-threshold
    path — and keeps awaiting the broadcast."""

    def __init__(self, member: int):
        super().__init__(f"home member {member} unreachable")
        self.member = member


class PartyWorker:
    """One party on ``device`` (the card unless ``"cpu"`` is asked for).

    ``record(obj)`` receives the per-round JSON record (round, device,
    kernel launches)."""

    def __init__(self, host: str, port: int, party_id: int, *,
                 die_after_upload: int | None = None,
                 die_before_upload: int | None = None,
                 tamper: str | None = None,
                 tamper_round: int | None = None,
                 poison: str | None = None,
                 poison_round: int | None = None, log=None,
                 device="cuda", record=None):
        self.device = dispatch.resolve_device(device)
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.record = record or (lambda obj: None)
        self.host = host
        self.port = port
        self.pid = int(party_id)
        self.die_after_upload = die_after_upload
        self.die_before_upload = die_before_upload
        if tamper is not None and tamper not in TAMPER_MODES:
            raise ValueError(
                f"unknown tamper mode {tamper!r}; expected one of "
                f"{TAMPER_MODES}")
        self.tamper = tamper
        self.tamper_round = tamper_round
        if poison is not None and poison not in DEALER_TAMPER_MODES:
            raise ValueError(
                f"unknown poison mode {poison!r}; expected one of "
                f"{DEALER_TAMPER_MODES}")
        self.poison = poison
        self.poison_round = poison_round
        self.log = log or (lambda msg: None)
        self.cfg: WireConfig | None = None
        self.agg = None
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, collections.deque] = (
            collections.defaultdict(collections.deque))
        #: the coordinator stream is read by one task at all times (see
        #: ``_read_loop``); ``_arrived`` wakes ``_next``, ``_read_error``
        #: holds how the stream ended
        self._arrived = asyncio.Event()
        self._reader_task: asyncio.Task | None = None
        self._read_error: BaseException | None = None
        self._probes: set[asyncio.Task] = set()
        #: registration-lease session id (WELCOME header, DESIGN.md §12);
        #: stamped into every outbound frame so the coordinator can
        #: reject frames from superseded/expired leases
        self.session = 0
        self._tally: np.ndarray | None = None
        self._prev_acc: np.ndarray | None = None
        #: previous round's honest regional sums (``{dst_member: row}``)
        #: — the replay tamper hook's material under the tree relay
        self._prev_region_acc: dict | None = None
        self.last_mean: np.ndarray | None = None
        #: tree relay (DESIGN.md §13): the always-on region listener
        #: (its address is advertised in HELLO so this party can serve
        #: as a home member), the queue its accept handler feeds, and
        #: the cached outbound connections to other members' listeners
        self._region_server: asyncio.Server | None = None
        self._region_addr: tuple[str, int] | None = None
        self._region_queue: asyncio.Queue | None = None
        self._region_out: dict = {}
        #: parties that ever HELLO'd this member's region listener —
        #: an UPLOAD_PROBE for a party in this set is ignored (its
        #: frames or its EOF sentinel will settle the verdict); only a
        #: party that *never connected* draws the fail-fast
        #: UPLOAD_DONE{done:false} answer
        self._region_seen: set[int] = set()
        #: the current round's :class:`RegionIngest` (probe answers
        #: consult its ``done`` set)
        self._cur_ingest: RegionIngest | None = None

    # -- framed IO --------------------------------------------------------

    async def _read_loop(self) -> None:
        """Read the coordinator stream without pause into ``_pending``.

        The reference reads only inside ``_next``, so a party stops
        reading while it uploads.  Under the hub relay the coordinator
        then blocks relaying a frame to a member that is itself blocked
        uploading, whose own frames wait behind that relay: once the
        frames outgrow the socket buffers (chunks of 2^20 elements are
        4 MiB), the hub deadlocks.  Reading always breaks that cycle;
        the frames on the wire are unchanged.
        """
        try:
            while True:
                frame = await read_frame(self.reader)
                if frame is None:
                    raise TruncatedFrameError(
                        "coordinator closed the stream")
                if frame.msg_type == MsgType.UPLOAD_PROBE:
                    # fail-fast upload verdict (tree relay): answered via
                    # the region queue so the verdict serializes after
                    # any frames/EOF the probed party already delivered
                    task = asyncio.ensure_future(self._enqueue_probe(frame))
                    self._probes.add(task)
                    task.add_done_callback(self._probes.discard)
                    continue
                self._pending[frame.msg_type].append(frame)
                self._arrived.set()
        except (WireError, ConnectionError, OSError) as e:
            self._read_error = e
            self._arrived.set()

    async def _next(self, *types: int) -> Frame:
        """Next frame of one of ``types``, in arrival order per type;
        everything else stays buffered.

        SHUTDOWN interrupts any wait — a party never hangs on a stage
        the coordinator has abandoned.
        """
        while True:
            for t in types:
                if self._pending[t]:
                    return self._pending[t].popleft()
            if self._pending[MsgType.SHUTDOWN]:
                raise _Shutdown()
            if self._read_error is not None:
                raise self._read_error
            self._arrived.clear()
            await self._arrived.wait()

    async def _enqueue_probe(self, frame: Frame) -> None:
        """Queue an UPLOAD_PROBE behind the region stream's events.

        A brief yield first: a probed party that connected moments
        before dying may have its HELLO sitting in the kernel buffer
        with the accept callback not yet run — give the event loop a
        beat so ``_region_seen`` reflects every connection that beat
        the probe onto the wire (the residual race is closed by the
        stage deadline, DESIGN.md §13)."""
        await asyncio.sleep(0.05)
        await self._region_queue.put(("probe", frame, 0, None))

    async def _send(self, frame: Frame) -> None:
        if self.session and frame.session == 0:
            frame = dataclasses.replace(frame, session=self.session)
        await write_frame(self.writer, frame)

    async def _send_chunked(self, msg_type: int, dst: int, *, round_index,
                            phase: int, arr: np.ndarray,
                            dtype_code: int) -> None:
        for frame in codec.chunk_frames(
                msg_type, arr, round_index=round_index, phase=phase,
                scheme=Scheme.CODES.get(self.cfg.scheme, 0),
                dtype_code=dtype_code, src=self.pid, dst=dst,
                chunk_elems=self.cfg.chunk_elems):
            await self._send(frame)

    async def _collect(self, assembler: MessageAssembler, msg_type: int,
                       expect_srcs: set[int]) -> dict[int, np.ndarray]:
        """Assemble one complete message per expected source."""
        done: dict[int, np.ndarray] = {}
        while set(done) != expect_srcs:
            frame = await self._next(msg_type)
            if frame.src not in expect_srcs:
                raise ProtocolError(
                    f"{frame.type_name()} from unexpected party "
                    f"{frame.src} (expecting {sorted(expect_srcs)})")
            if frame.src in done:
                raise ProtocolError(
                    f"duplicate {frame.type_name()} from {frame.src}")
            arr = assembler.feed(frame)
            if arr is not None:
                done[frame.src] = arr
        return done

    # -- device math over host words (bit-identical to the sim's) -------

    def _words(self, arr: np.ndarray) -> torch.Tensor:
        """Host ``uint32`` words on the worker's device, in its carrier."""
        return codec.device_words(arr, self.device)

    def _fold_all(self, rows, d: int) -> np.ndarray:
        """Ring/field sum of host word rows on the device: one ``int64``
        sum, masked to 32 bits (Z_2^32) or reduced mod p (F_p) — the
        residues of the reference's pairwise ``uint64`` folds, in any
        order."""
        if not rows:
            return np.zeros(d, dtype=np.uint32)
        x = self._words(np.stack(rows)).to(torch.int64) & U32_MASK
        total = x.sum(dim=0)
        total = (total % MERSENNE_P if self.cfg.scheme == "shamir"
                 else total & U32_MASK)
        return codec.host_u32(total)

    def _verify(self, rows: np.ndarray, commits: np.ndarray,
                points) -> np.ndarray:
        """``kernels.verify_shares`` on the device: bool ``[k, D]``."""
        ok = verify_shares(self._words(rows), self._words(commits),
                           tuple(points))
        return ok.cpu().numpy().astype(bool)

    def _aggregate_commits(self, commits: np.ndarray) -> np.ndarray:
        """Pointwise product of dealers' commitment words, on the
        device (plain PyTorch, as in the sim)."""
        return codec.host_u32(vss.aggregate_commits(self._words(commits)))

    def _reconstruct_mean(self, member_sums: np.ndarray, n: int,
                          points=None) -> np.ndarray:
        """The reconstruct kernel of the scheme on the device."""
        mean = self.agg.reconstruct_mean(self._words(member_sums), n,
                                         points=points)
        return mean.cpu().numpy()

    def _decoded_update(self, stack: np.ndarray, points) -> np.ndarray:
        """One dealer's decoded update from its member rows (the audit)."""
        code = self.agg.reconstruct_sum(self._words(stack), points=points)
        return self.agg.fp.decode_mean(code, 1).cpu().numpy()

    # -- Phase I: election subround (Alg. 2) ------------------------------

    async def _election_subround(self, elect: Frame) -> None:
        cfg = self.cfg
        body = codec.decode_json(elect.payload)
        subround = int(body["subround"])
        round_index = elect.round
        # cohort mode (DESIGN.md §12): the ELECT body names the round's
        # sampled voter set; votes land in [0, c) and are tallied over
        # positions in sorted(ids) — the exact mirror of
        # committee.elect_among (full participation when absent)
        ids = sorted(int(i) for i in body.get("cohort")
                     or range(cfg.n))
        c = len(ids)
        my_pos = ids.index(self.pid)
        if subround == 0:
            self._tally = np.zeros(c, dtype=np.int64)
        elect_seed = cfg.seed + round_index
        k0, k1 = philox.derive_key(elect_seed, (subround << 20) | self.pid)
        votes = committee_mod.draw_votes(c, cfg.b, k0, k1,
                                         round_index=subround)
        shares = codec.host_u32(additive_share(votes, c, k0, k1))  # [c, b]
        peers = {j for j in ids if j != self.pid}
        for p, j in enumerate(ids):
            if j == self.pid:
                continue
            await self._send_chunked(
                MsgType.VOTE_SHARE, j, round_index=round_index,
                phase=Phase.PHASE1, arr=shares[p],
                dtype_code=Wiredtype.UINT32)
        asm = MessageAssembler(round_index=round_index)
        got = await self._collect(asm, MsgType.VOTE_SHARE, peers)
        partial = shares[my_pos]
        for arr in got.values():              # wraparound: order-free
            partial = (partial + arr.astype(np.uint32)).astype(np.uint32)
        for j in peers:
            await self._send_chunked(
                MsgType.VOTE_PARTIAL, j, round_index=round_index,
                phase=Phase.PHASE1, arr=partial,
                dtype_code=Wiredtype.UINT32)
        got = await self._collect(asm, MsgType.VOTE_PARTIAL, peers)
        total = partial
        for arr in got.values():
            total = (total + arr.astype(np.uint32)).astype(np.uint32)
        self._tally += committee_mod.tally_votes(total, c)
        # eviction/reputation state is coordinator-broadcast in the
        # ELECT body so every party applies the identical filter and
        # weighting — the conformance check requires unanimity.  Both
        # stay keyed by *global* id on the wire; map to tally positions
        # exactly as elect_among does
        excluded = set(int(i) for i in body.get("exclude") or ())
        weights = body.get("weights") or None
        pos_exclude = [p for p, i in enumerate(ids) if i in excluded]
        pos_weights = None
        if weights is not None:
            weights = {int(k): float(v) for k, v in weights.items()}
            pos_weights = {p: weights.get(i, 1.0)
                           for p, i in enumerate(ids)}
        committee = committee_mod.select_committee(
            self._tally, cfg.m, exclude=pos_exclude,
            reputation=pos_weights)
        report = ([ids[p] for p in committee]
                  if len(committee) == cfg.m else None)
        await self._send(Frame(
            MsgType.COMMITTEE, round=round_index, src=self.pid,
            payload=codec.encode_json({"committee": report})))
        self.log(f"election r{round_index}.{subround}: "
                 f"tally committee={report}")

    # -- Phase II: aggregation round (Alg. 3) -----------------------------

    async def _round(self, start: Frame) -> None:
        cfg = self.cfg
        body = codec.decode_json(start.payload)
        round_index = start.round
        ids: list[int] = body["party_ids"]
        committee: list[int] = body["committee"]
        d = int(body["d"])
        # the round's own launches: the warm-up's are not counted
        dispatch.reset_launches()
        # host wall seconds of the round's steps, for the round's record
        t_start = time.perf_counter()
        times = {}
        participant = self.pid in ids
        member = self.pid in committee
        asm = MessageAssembler(round_index=round_index)
        tree = cfg.relay == "tree"
        home: dict[int, int] = {}
        addrs: dict[int, tuple[str, int]] = {}
        roster: dict[int, int] = {}
        if tree:
            home = {int(k): int(v)
                    for k, v in (body.get("home") or {}).items()}
            addrs = {int(k): (str(v[0]), int(v[1]))
                     for k, v in (body.get("addrs") or {}).items()}
            roster = {int(k): int(v)
                      for k, v in (body.get("sessions") or {}).items()}

        if self.die_before_upload == round_index:
            # TEST HOOK: die before the first share frame — under the
            # tree relay this party never reaches its home member's
            # region listener, so only the coordinator's UPLOAD_PROBE
            # fail-fast (not the stage deadline) can settle its verdict
            self.log(f"test hook: dying before round {round_index} "
                     "upload")
            os._exit(1)

        if participant:
            got = await self._collect(asm, MsgType.INPUT, {-1})
            times["input_s"] = time.perf_counter() - t_start
            t_up = time.perf_counter()
            times["share_s"] = 0.0
            flat = got[-1].astype(np.float32, copy=False)
            if flat.shape[0] != d:
                raise ProtocolError(
                    f"INPUT carried {flat.shape[0]} elements, "
                    f"ROUND_START promised {d}")
            poisoning = self.poison_round == round_index
            if poisoning and self.poison in ("scale", "sign_flip"):
                # TEST HOOK: model-replacement poison — the dealer
                # deals *honestly* (shares AND commitments) over a
                # boosted update; only the norm audit can catch it
                factor = np.float32(POISON_SCALE if self.poison == "scale"
                                    else -POISON_SCALE)
                flat = (flat * factor).astype(np.float32)
                self.log(f"test hook: poisoning round {round_index} "
                         f"input ({self.poison})")
            # the update moves to the device once; shares and
            # commitments are made there
            flat = torch.from_numpy(np.array(flat)).to(self.device)
            malformed = poisoning and self.poison == "malformed"
            if malformed:
                self.log(f"test hook: malforming round {round_index} "
                         "share stream (honest commitments)")
            # stream shares chunk-by-chunk: elem_base keeps the Philox
            # counters exactly where the whole-vector call would put
            # them, so no [m, d] stack ever materializes per frame.
            # Tree relay: every upload frame (and commitment frame)
            # goes to this party's home member's region listener; a
            # home member dying mid-upload loses the region for this
            # round (sub-threshold degradation), it does not kill the
            # party — it just keeps awaiting the broadcast
            try:
                upload_send = (await self._region_uplink(
                    home.get(self.pid), addrs) if tree else self._send)
                for e_lo in range(0, d, cfg.chunk_elems):
                    e_hi = min(e_lo + cfg.chunk_elems, d)
                    # one share launch a chunk; the [m, chunk] stack
                    # comes back to the host once, to be framed
                    t_sh = time.perf_counter()
                    stack = codec.host_u32(self.agg.make_shares_batch(
                        flat[None, e_lo:e_hi], seed=cfg.seed,
                        party_ids=[self.pid], round_index=round_index,
                        elem_base=e_lo)[0])            # [m, chunk]
                    times["share_s"] += time.perf_counter() - t_sh
                    if malformed:
                        # corrupt the share stream while the commitment
                        # stream below stays honest — the per-dealer VSS
                        # verify at every member catches exactly this
                        stack = stack ^ np.uint32(TAMPER_FLIP_MASK)
                    if cfg.vss:
                        # commitments for this chunk go out BEFORE its
                        # uploads: the coordinator's relay-before-meter
                        # ordering (FIFO on the region socket, in tree
                        # mode) then guarantees a member holds every
                        # included dealer's commitments once COMMIT
                        # lands (same invariant the shares rely on)
                        await self._send_commitments(
                            round_index, committee, flat, d, e_lo, e_hi,
                            send=upload_send)
                    for w, member_id in enumerate(committee):
                        _, payload = codec.encode_array(stack[w])
                        await upload_send(Frame(
                            MsgType.SHARE_UPLOAD, round=round_index,
                            phase=Phase.PHASE2_UPLOAD,
                            scheme=Scheme.CODES[cfg.scheme],
                            dtype=Wiredtype.UINT32, src=self.pid,
                            dst=member_id, chunk_off=e_lo, total_elems=d,
                            payload=payload))
            except _RegionDead as e:
                self.log(f"round {round_index}: home member {e.member} "
                         "unreachable mid-upload — region lost this "
                         "round, awaiting broadcast")
            if self.die_after_upload == round_index:
                # frames are already drained to the kernel (write_frame
                # awaits drain); process exit sends FIN *after* them, so
                # the coordinator sees a complete upload then EOF
                self.log(f"test hook: dying after round {round_index} "
                         "uploads")
                os._exit(1)

            times["upload_s"] = time.perf_counter() - t_up

        if member:
            t_member = time.perf_counter()
            await self._send(Frame(MsgType.READY, round=round_index,
                                   src=self.pid))
            if tree:
                await self._member_duties_tree(round_index, ids,
                                               committee, d, asm,
                                               home, roster)
            else:
                await self._member_duties(round_index, ids, committee,
                                          d, asm)
            times["member_s"] = time.perf_counter() - t_member

        # every connected party receives the aggregate (Alg. 3 l.22).
        # A pipelined coordinator may interleave round r+1's Phase I
        # here — ELECT frames are served inline so the next election
        # genuinely overlaps this round's tail at the parties too
        serving = committee[self.pid % len(committee)]
        mean = None
        while mean is None:
            frame = await self._next(MsgType.BROADCAST, MsgType.ELECT)
            if frame.msg_type == MsgType.ELECT:
                await self._election_subround(frame)
                continue
            if frame.src != serving:
                raise ProtocolError(
                    f"BROADCAST from unexpected member {frame.src} "
                    f"(expecting {serving})")
            mean = asm.feed(frame)
        self.last_mean = mean
        self.log(f"round {round_index} done "
                 f"(|G|={np.linalg.norm(self.last_mean):.4f})")
        times["round_s"] = time.perf_counter() - t_start
        self.record({"party": self.pid, "round": round_index,
                     "device": self.device_name,
                     "launches": {k: v for k, v in
                                  dispatch.launches.items() if v},
                     **times})

    async def _send_commitments(self, round_index: int, committee,
                                flat: torch.Tensor, d: int, e_lo: int,
                                e_hi: int, send=None) -> None:
        """Feldman commitments for elements [e_lo, e_hi) to every member.

        The commitment stream re-derives the chunk's coefficient words
        with the same ``counter_base`` the share stream used, so the
        chunked commitments are bit-identical slices of the
        whole-vector commitments (the §8 invariant extended to §10).
        The element-major word layout makes the chunk a contiguous
        ``chunk_off`` range of the ``d*(degree+1)*2``-word logical
        message.
        """
        cfg = self.cfg
        deg = cfg.degree()
        k0, k1 = philox.derive_key(cfg.seed,
                                   (round_index << 24) | self.pid)
        code = self.agg.encode(flat[e_lo:e_hi])
        words = codec.host_u32(
            vss.feldman_commit(code, k0, k1, degree=deg,
                               counter_base=e_lo // 4)).reshape(-1)
        stride = (deg + 1) * 2
        send = send or self._send
        for member_id in committee:
            for frame in codec.chunk_frames(
                    MsgType.COMMITMENT, words, round_index=round_index,
                    phase=Phase.PHASE2_COMMIT,
                    scheme=Scheme.CODES[cfg.scheme],
                    dtype_code=Wiredtype.UINT32, src=self.pid,
                    dst=member_id, chunk_elems=cfg.chunk_elems,
                    chunk_base=e_lo * stride, total_elems=d * stride):
                await send(frame)

    def _apply_tamper(self, acc: np.ndarray, round_index: int,
                      d: int) -> np.ndarray:
        """TEST HOOK: corrupt this member's partial sum (the VSS
        adversary).  Constants match the sim's injection so both paths
        exercise the same detector."""
        if self.tamper is None or self.tamper_round != round_index:
            return acc
        self.log(f"test hook: tampering round {round_index} partial "
                 f"sum ({self.tamper})")
        if self.tamper == "flip":
            return acc ^ np.uint32(TAMPER_FLIP_MASK)
        if self.tamper == "wrong_poly":
            k0, k1 = philox.derive_key(
                self.cfg.seed ^ TAMPER_SEED_XOR,
                (round_index << 24) | self.pid)
            # the identical row the sim's wrong_poly injection
            # fabricates
            return codec.host_u32(to_field(philox.random_bits(d, k0, k1)))
        # replay: the member's round r-1 partial sum
        if self._prev_acc is None or self._prev_acc.shape[0] != d:
            raise ProtocolError(
                "replay tamper hook needs a previous round's partial "
                "sum of the same model size")
        return self._prev_acc

    def _verify_dealer_shares(self, buffers, commit_bufs, included,
                              my_point: int, d: int):
        """Party-side verification before the member sum: every
        included dealer's share must satisfy its own commitments.
        Returns the list of blamed dealer ids (normally empty)."""
        deg = self.cfg.degree()
        # one batched kernel call: dealers concatenate on the element
        # axis (each element verifies against its own dealer's
        # commitment columns)
        rows = np.concatenate([buffers[p] for p in included])[None, :]
        commits = np.concatenate(
            [commit_bufs[p].reshape(d, deg + 1, 2) for p in included])
        ok = self._verify(rows, commits, (my_point,))[0]
        ok_per_dealer = ok.reshape(len(included), d).all(axis=1)
        return [p for k, p in enumerate(included) if not ok_per_dealer[k]]

    async def _audit_dealers(self, round_index: int, rows, order,
                             committee, included, buffers,
                             asm: MessageAssembler, d: int):
        """Final-member norm-bound audit (DESIGN.md §11).

        Collects every non-final member's per-dealer rows (DEALER_ROWS),
        checks each matrix refolds to the member's partial-sum row
        (protocol integrity — a member cannot tell the audit one story
        and the reconstruction another), reconstructs each dealer's
        decoded update, and blames dealers whose L2 norm exceeds
        ``cfg.norm_bound`` (BLAME kind="poison", non-fatal).  Returns
        ``(honest_dealers, cleaned_rows)`` — the member rows refolded
        over honest dealers only, bit-identical to the sim transport's
        cleaned ``reduce_party_shares`` (modular adds are
        order-independent).
        """
        cfg = self.cfg
        l = len(included)
        matrices = {self.pid: np.concatenate(
            [buffers[p] for p in included])}
        if len(order) > 1:
            matrices.update(await self._collect(
                asm, MsgType.DEALER_ROWS, set(order[:-1])))
        per_member: dict[int, np.ndarray] = {}
        for w in order:
            mat = matrices[w].astype(np.uint32, copy=False)
            if mat.shape[0] != l * d:
                raise ProtocolError(
                    f"member {w} audit rows carry {mat.shape[0]} "
                    f"words, expected {l * d}")
            per_member[w] = mat.reshape(l, d)
            refold = self._fold_all(list(per_member[w]), d)
            if not np.array_equal(refold, rows[w]):
                raise ProtocolError(
                    f"member {w} audit rows do not refold to its "
                    "partial-sum row (inconsistent audit evidence)")
        pts = (None if len(order) == len(committee) else
               tuple(committee.index(w) + 1 for w in order))
        blamed = []
        for k_i, p in enumerate(included):
            stack = np.stack([per_member[w][k_i] for w in order])
            decoded = self._decoded_update(stack, pts)
            if update_norm(decoded) > cfg.norm_bound:
                blamed.append(p)
        if blamed:
            self.log(f"round {round_index}: blaming dealers {blamed} "
                     f"(norm bound {cfg.norm_bound} exceeded)")
            await self._send(Frame(
                MsgType.BLAME, round=round_index, src=self.pid,
                payload=codec.encode_json(
                    {"kind": "poison", "blamed": blamed,
                     "round": round_index})))
        honest = [p for p in included if p not in blamed]
        if not honest:
            raise ProtocolError(
                f"the norm audit blamed every dealer {included} — no "
                "honest update left to aggregate")
        if not blamed:
            return honest, rows
        cleaned = {}
        for w in order:
            cleaned[w] = self._fold_all(
                [per_member[w][k_i] for k_i, p in enumerate(included)
                 if p not in blamed], d)
        return honest, cleaned

    async def _audit_tree_dealers(self, round_index: int, rows, order,
                                  committee, good_inc, region_map,
                                  ingest: RegionIngest, bad, asm, d):
        """Final-member norm-bound audit over the tree (DESIGN.md §13).

        The tree twin of :meth:`_audit_dealers`: the per-dealer rows
        live on each dealer's *home member*, so every non-final member
        escrowed its region's ``[|region|·m·d]`` matrix (DEALER_ROWS,
        phase PHASE2_AUDIT, included-order × committee-order).  The
        final member checks the escrow refolds to every surviving
        member's chain row (inconsistent evidence is protocol-fatal),
        reconstructs each dealer's decoded update from its escrowed
        rows, blames norm violators (kind="poison"), and returns
        ``(honest_dealers, member_rows)`` refolded over the honest
        dealers — bit-identical to the hub audit because the modular
        adds regroup freely.  Regions condemned by the REGION_SUM
        check (``bad``) are already out wholesale: their escrow is
        collected (it is on the wire regardless) and discarded.
        """
        cfg = self.cfg
        escrow_senders = {h for h in order
                          if h != self.pid and region_map[h]}
        matrices = {}
        if escrow_senders:
            matrices = await self._collect(
                asm, MsgType.DEALER_ROWS, escrow_senders)
        per_dealer: dict[tuple[int, int], np.ndarray] = {}
        for p in region_map.get(self.pid, []):
            for w in committee:
                per_dealer[(p, w)] = ingest.rows[(p, w)]
        m = len(committee)
        for h in sorted(escrow_senders):
            reg = region_map[h]
            mat = matrices[h].astype(np.uint32, copy=False)
            if mat.shape[0] != len(reg) * m * d:
                raise ProtocolError(
                    f"member {h} escrowed {mat.shape[0]} words, "
                    f"expected {len(reg) * m * d}")
            if h in bad:
                continue
            mat = mat.reshape(len(reg), m, d)
            for i, p in enumerate(reg):
                for j, w in enumerate(committee):
                    per_dealer[(p, w)] = mat[i, j]
        good_order = [w for w in order if w not in bad]
        for w in good_order:
            refold = self._fold_all([per_dealer[(p, w)] for p in good_inc],
                                    d)
            if not np.array_equal(refold, rows[w]):
                raise ProtocolError(
                    f"escrowed per-dealer rows do not refold to "
                    f"member {w}'s partial-sum row (inconsistent "
                    "audit evidence)")
        pts = (None if len(good_order) == len(committee) else
               tuple(committee.index(w) + 1 for w in good_order))
        blamed = []
        for p in good_inc:
            stack = np.stack([per_dealer[(p, w)] for w in good_order])
            decoded = self._decoded_update(stack, pts)
            if update_norm(decoded) > cfg.norm_bound:
                blamed.append(p)
        if blamed:
            self.log(f"round {round_index}: blaming dealers {blamed} "
                     f"(norm bound {cfg.norm_bound} exceeded)")
            await self._send(Frame(
                MsgType.BLAME, round=round_index, src=self.pid,
                payload=codec.encode_json(
                    {"kind": "poison", "blamed": blamed,
                     "round": round_index})))
        honest = [p for p in good_inc if p not in blamed]
        if not honest:
            raise ProtocolError(
                f"the norm audit blamed every dealer {good_inc} — no "
                "honest update left to aggregate")
        if not blamed:
            return honest, rows
        cleaned = dict(rows)
        for w in good_order:
            cleaned[w] = self._fold_all(
                [per_dealer[(p, w)] for p in honest], d)
        return honest, cleaned

    async def _member_duties(self, round_index: int, ids, committee, d,
                             asm: MessageAssembler) -> None:
        cfg = self.cfg
        buffers: dict[int, np.ndarray] = {}
        commit_bufs: dict[int, np.ndarray] = {}
        commit = None
        deg = cfg.degree()
        commit_words = d * (deg + 1) * 2

        def _feed_data(frame) -> None:
            arr = asm.feed(frame)
            if arr is None:
                return
            arr = arr.astype(np.uint32, copy=False)
            if frame.msg_type == MsgType.COMMITMENT:
                commit_bufs[frame.src] = arr
            else:
                buffers[frame.src] = arr

        # uploads (and commitments, under VSS) are buffered until
        # COMMIT names the included set — a party that died mid-upload
        # must not leak partial chunks into the member's sum (ring/
        # field sums have no "partial" notion)
        data_types = ((MsgType.SHARE_UPLOAD, MsgType.COMMITMENT)
                      if cfg.vss else (MsgType.SHARE_UPLOAD,))
        while commit is None:
            frame = await self._next(*data_types, MsgType.COMMIT)
            if frame.msg_type == MsgType.COMMIT:
                commit = codec.decode_json(frame.payload)
                break
            _feed_data(frame)
        included: list[int] = commit["included"]
        live_members: list[int] = commit["live_members"]
        l = int(commit["l"])

        def _missing():
            out = [p for p in included if p not in buffers]
            if cfg.vss:
                out += [p for p in included if p not in commit_bufs]
            return out

        while _missing():     # relay-before-COMMIT ordering makes this
            frame = await self._next(*data_types)        # a no-op path
            _feed_data(frame)

        if cfg.vss:
            for p in included:
                if commit_bufs[p].shape[0] != commit_words:
                    raise ProtocolError(
                        f"dealer {p} commitment carries "
                        f"{commit_bufs[p].shape[0]} words, expected "
                        f"{commit_words}")
            my_point = committee.index(self.pid) + 1
            bad_dealers = self._verify_dealer_shares(
                buffers, commit_bufs, included, my_point, d)
            if bad_dealers:
                # a dealer whose share fails its own commitments is a
                # protocol-fatal fault: members cannot agree on an
                # included set unilaterally, so blame loudly and abort
                await self._send(Frame(
                    MsgType.BLAME, round=round_index, src=self.pid,
                    payload=codec.encode_json(
                        {"kind": "dealer", "blamed": bad_dealers,
                         "round": round_index})))
                raise ProtocolError(
                    f"dealer share verification failed for parties "
                    f"{bad_dealers} at member {self.pid}")

        # the member sum on the device (Alg. 3 l.15)
        acc = self._fold_all([buffers[p] for p in included], d)
        honest_acc = acc
        acc = self._apply_tamper(acc, round_index, d)
        self._prev_acc = honest_acc

        order = live_members
        my_idx = order.index(self.pid)
        k = len(order)
        l_eff = l
        if cfg.scheme == "additive":
            # Alg. 3 chain: each member adds its local sum and passes on
            if my_idx > 0:
                got = await self._collect(asm, MsgType.CHAIN_SUM,
                                          {order[my_idx - 1]})
                acc = self._fold_all([acc, got[order[my_idx - 1]]], d)
            if my_idx < k - 1:
                await self._send_chunked(
                    MsgType.CHAIN_SUM, order[my_idx + 1],
                    round_index=round_index, phase=Phase.PHASE2_EXCHANGE,
                    arr=acc, dtype_code=Wiredtype.UINT32)
                return
            member_sums = acc[None, :]
            points = None
        else:
            # Shamir rows must stay distinct: non-final members send
            # their sum row to the final live member (same m−1 count)
            audit = cfg.norm_bound is not None
            if my_idx < k - 1:
                if audit:
                    # per-dealer rows ride ahead of the sum row so the
                    # final member can reconstruct each dealer's update
                    # individually (one logical l·d message per member
                    # — costmodel.phase2_audit_*)
                    await self._send_chunked(
                        MsgType.DEALER_ROWS, order[-1],
                        round_index=round_index,
                        phase=Phase.PHASE2_AUDIT,
                        arr=np.concatenate(
                            [buffers[p] for p in included]),
                        dtype_code=Wiredtype.UINT32)
                await self._send_chunked(
                    MsgType.CHAIN_SUM, order[-1],
                    round_index=round_index, phase=Phase.PHASE2_EXCHANGE,
                    arr=acc, dtype_code=Wiredtype.UINT32)
                return
            rows = {self.pid: acc}
            if k > 1:
                rows.update(await self._collect(
                    asm, MsgType.CHAIN_SUM, set(order[:-1])))
            honest = list(included)
            if audit:
                honest, rows = await self._audit_dealers(
                    round_index, rows, order, committee, included,
                    buffers, asm, d)
                l_eff = len(honest)
            use_order = list(order)
            if cfg.vss:
                agg_commits = self._aggregate_commits(np.stack(
                    [commit_bufs[p].reshape(d, deg + 1, 2)
                     for p in honest]))
                use_order = await self._verify_member_rows(
                    round_index, rows, order, committee, agg_commits)
            member_sums = np.stack([rows[w] for w in use_order])
            points = (None if len(use_order) == len(committee) else
                      tuple(committee.index(w) + 1 for w in use_order))

        mean = self._reconstruct_mean(member_sums, l_eff, points=points)
        await self._send_chunked(
            MsgType.RESULT, -1, round_index=round_index,
            phase=Phase.WIRE_RESULT, arr=mean,
            dtype_code=Wiredtype.FLOAT32)

    async def _region_event(self, ingest: RegionIngest, event,
                            round_index: int) -> None:
        """Process one region-queue event (a frame or an EOF sentinel).

        Completions and incomplete-stream deaths are reported to the
        coordinator (UPLOAD_DONE / UPLOAD_DONE{done:false}) — the
        coordinator's upload stage settles on these verdicts, since a
        party's coordinator-socket EOF proves nothing about an upload
        that traveled the tree.  A stale session is answered with an
        ERROR frame on the region socket (the coordinator's per-frame
        gate, mirrored); other protocol violations drop the frame."""
        kind, payload, session, writer = event
        if kind == "eof":
            src = int(payload)
            if src in ingest.roster and src not in ingest.done:
                await self._send(Frame(
                    MsgType.UPLOAD_DONE, round=round_index,
                    src=self.pid, payload=codec.encode_json(
                        {"party": src, "done": False})))
            return
        if kind == "probe":
            # coordinator UPLOAD_PROBE: its socket EOF'd a party homed
            # here.  A party that ever connected settles through its
            # own stream (queued frames complete it, or the EOF
            # sentinel reports it); one that never connected can only
            # settle here — answer its dropout verdict immediately
            # instead of letting the stage deadline expire
            probe: Frame = payload
            if probe.round != round_index:
                return
            src = int(codec.decode_json(probe.payload)["party"])
            if (src in ingest.roster and src not in ingest.done
                    and src not in self._region_seen):
                await self._send(Frame(
                    MsgType.UPLOAD_DONE, round=round_index,
                    src=self.pid, payload=codec.encode_json(
                        {"party": src, "done": False})))
            return
        frame: Frame = payload
        try:
            done_src = ingest.feed(frame, session)
        except StaleSessionError as e:
            self.log(f"region frame from {frame.src} rejected: {e}")
            if writer is not None:
                with contextlib.suppress(Exception):
                    await write_frame(writer, Frame(
                        MsgType.ERROR, src=self.pid,
                        payload=codec.encode_json({"error": str(e)})))
            return
        except ProtocolError as e:
            self.log(f"region frame from {frame.src} dropped: {e}")
            return
        if done_src is not None:
            await self._send(Frame(
                MsgType.UPLOAD_DONE, round=round_index, src=self.pid,
                payload=codec.encode_json({"party": done_src})))

    async def _member_duties_tree(self, round_index: int, ids, committee,
                                  d, asm: MessageAssembler, home,
                                  roster) -> None:
        """Member duties under the committee-sharded relay tree
        (DESIGN.md §13).

        Until COMMIT lands the member multiplexes two sources: its
        coordinator socket (COMMIT + control) and its region queue (its
        region's SHARE_UPLOAD/COMMITMENT streams, fed by the region
        listener).  Post-COMMIT it ships the METER digest (the Eq. 3–6
        reconciliation), folds its region locally, exchanges per-member
        regional sums (REGION_SUM, coordinator-relayed, the m·(m−1)
        leg of the per-link closed form), and joins the same
        chain/reconstruct tail the hub path runs — modular adds and
        the commitment group product are order-free, so the mean and
        the VSS verdicts stay bit-identical to hub and sim.

        Malicious-member hardening (DESIGN.md §13): under VSS every
        member also broadcasts its *regional aggregate commitments*
        (REGION_COMMIT, to every other live member, the matching
        m·(m−1) leg), and each receiver verifies every incoming
        REGION_SUM against the sender's commitments at its own
        evaluation point *before* folding.  A sum that fails draws a
        BLAME kind="region" on the *sender*, the receiver excludes that
        region (sum and dealers) from its fold, and the round degrades
        to sub-threshold reconstruction over the surviving regions —
        the tamperer is evicted instead of the round aborting with
        every member blamed.  Under ``norm_bound`` the commitments
        travel per-dealer and every non-final member escrows its
        region's per-dealer rows to the final member (DEALER_ROWS,
        phase PHASE2_AUDIT), so the hub's norm audit composes with the
        tree."""
        cfg = self.cfg
        deg = cfg.degree()
        commit_words = d * (deg + 1) * 2
        ingest = RegionIngest(
            round_index=round_index, roster=roster,
            expect_msgs=cfg.m * (2 if cfg.vss else 1))
        self._cur_ingest = ingest
        region = sorted(p for p in ids if home.get(p) == self.pid)

        commit = None
        commit_task = asyncio.ensure_future(self._next(MsgType.COMMIT))
        try:
            while commit is None:
                if commit_task.done():
                    commit = codec.decode_json(
                        commit_task.result().payload)
                    break
                get_task = asyncio.ensure_future(
                    self._region_queue.get())
                await asyncio.wait({commit_task, get_task},
                                   return_when=asyncio.FIRST_COMPLETED)
                if get_task.done() and not get_task.cancelled():
                    await self._region_event(ingest, get_task.result(),
                                             round_index)
                else:
                    # Queue.get never consumes an item once cancelled
                    get_task.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await get_task
        finally:
            if not commit_task.done():
                commit_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await commit_task
        included = [int(p) for p in commit["included"]]
        live_members = [int(w) for w in commit["live_members"]]
        l = int(commit["l"])
        region_inc = [p for p in region if p in set(included)]
        if not ingest.complete(region_inc):
            # the coordinator includes a party only after THIS member's
            # UPLOAD_DONE, and COMMIT arrives after that send on the
            # same FIFO socket — the tree-mode relay-before-COMMIT
            raise ProtocolError(
                f"COMMIT names region parties "
                f"{sorted(set(region_inc) - ingest.done)} whose uploads "
                "this member never completed (UPLOAD_DONE causality "
                "violated)")

        if cfg.vss and region_inc:
            for p in region_inc:
                for w in committee:
                    buf = ingest.commits[(p, w)]
                    if buf.shape[0] != commit_words:
                        raise ProtocolError(
                            f"dealer {p} commitment carries "
                            f"{buf.shape[0]} words, expected "
                            f"{commit_words}")
            # the home member is its region's sole verifier — it holds
            # every dealer's full share matrix, so it checks ALL m rows
            # (strictly stronger than the hub's one-point-per-member
            # check; one batched kernel call either way)
            rows_mat = np.stack(
                [np.concatenate([ingest.rows[(p, w)]
                                 for p in region_inc])
                 for w in committee])
            commits = np.concatenate(
                [ingest.commits[(p, self.pid)].reshape(d, deg + 1, 2)
                 for p in region_inc])
            points = tuple(range(1, len(committee) + 1))
            ok = self._verify(rows_mat, commits, points)
            ok_dealer = ok.reshape(len(committee), len(region_inc),
                                   d).all(axis=(0, 2))
            bad = [p for k, p in enumerate(region_inc)
                   if not ok_dealer[k]]
            if bad:
                await self._send(Frame(
                    MsgType.BLAME, round=round_index, src=self.pid,
                    payload=codec.encode_json(
                        {"kind": "dealer", "blamed": bad,
                         "round": round_index})))
                raise ProtocolError(
                    f"dealer share verification failed for parties "
                    f"{bad} at home member {self.pid}")

        # METER digest before any region sum / chain traffic: RESULT
        # causally depends on those, so the coordinator can require
        # every live member's digest once the mean assembles
        await self._send(Frame(
            MsgType.METER, round=round_index, src=self.pid,
            payload=codec.encode_json({"counters": ingest.digest()})))

        def region_of(h: int) -> list[int]:
            return sorted(p for p in included if home.get(p) == h)

        audit = cfg.norm_bound is not None
        region_acc = {w: self._fold_all(
                          [ingest.rows[(p, w)] for p in region_inc], d)
                      for w in committee}
        # TEST HOOK: the tree VSS adversary corrupts its *outgoing*
        # regional sums — every receiver's commitment check then draws
        # the blame onto this SENDER (kind="region"), which is the
        # hardening the adversarial battery pins.  wrong_poly keeps the
        # hub's own-row semantics (applied below), as does any mode
        # when this member's region is empty.
        region_tamper = (self.tamper in ("flip", "replay")
                         and self.tamper_round == round_index
                         and bool(region_inc))
        out_acc = region_acc
        if region_tamper:
            self.log(f"test hook: tampering round {round_index} "
                     f"outgoing REGION_SUMs ({self.tamper})")
            if self.tamper == "flip":
                out_acc = {w: region_acc[w] ^ np.uint32(TAMPER_FLIP_MASK)
                           for w in committee}
            else:                                           # replay
                prev = self._prev_region_acc
                if not prev or any(
                        committee.index(w) + 1 not in prev
                        or prev[committee.index(w) + 1].shape[0] != d
                        for w in committee):
                    raise ProtocolError(
                        "replay tamper hook needs a previous round's "
                        "regional sums of the same model size")
                out_acc = {w: prev[committee.index(w) + 1]
                           for w in committee}
        # keyed by evaluation point so the replay hook survives a
        # committee change between rounds (points are positional)
        self._prev_region_acc = {committee.index(w) + 1: region_acc[w]
                                 for w in committee}
        # ship every other live member its regional sum — and, under
        # VSS, this region's commitments (REGION_COMMIT): the pointwise
        # product over the region's dealers normally, the per-dealer
        # concatenation when the norm audit needs dealer granularity.
        # Member w's full sum is the fold of all regional sums
        # addressed to it (exact modular adds — order-free, so the
        # regrouping is bit-identical to the hub's per-dealer fold)
        if region_inc:
            for w in live_members:
                if w == self.pid:
                    continue
                await self._send_chunked(
                    MsgType.REGION_SUM, w, round_index=round_index,
                    phase=Phase.WIRE_REGION, arr=out_acc[w],
                    dtype_code=Wiredtype.UINT32)
        my_dealer_commits = None
        my_agg = None
        if cfg.vss and region_inc:
            my_dealer_commits = np.stack(
                [ingest.commits[(p, self.pid)].reshape(d, deg + 1, 2)
                 for p in region_inc])
            my_agg = self._aggregate_commits(my_dealer_commits)
            out_commits = (my_dealer_commits if audit
                           else my_agg).reshape(-1)
            for w in live_members:
                if w == self.pid:
                    continue
                await self._send_chunked(
                    MsgType.REGION_COMMIT, w, round_index=round_index,
                    phase=Phase.WIRE_REGION, arr=out_commits,
                    dtype_code=Wiredtype.UINT32)
        # escrow leg (norm audit over the tree, DESIGN.md §13): the
        # per-dealer rows live only on each dealer's home member, so
        # every non-final member streams its region's matrix to the
        # final member — one [|region|·m·d]-word DEALER_ROWS message,
        # included-order × committee-order
        final = live_members[-1]
        if audit and region_inc and self.pid != final:
            await self._send_chunked(
                MsgType.DEALER_ROWS, final, round_index=round_index,
                phase=Phase.PHASE2_AUDIT,
                arr=np.concatenate(
                    [ingest.rows[(p, w)] for p in region_inc
                     for w in committee]),
                dtype_code=Wiredtype.UINT32)

        senders = {h for h in live_members
                   if h != self.pid and region_of(h)}
        got: dict[int, np.ndarray] = {}
        if senders:
            got = await self._collect(asm, MsgType.REGION_SUM, senders)
        bad: list[int] = []
        peer_agg: dict[int, np.ndarray] = {}
        peer_dealer_commits: dict[int, np.ndarray] = {}
        if cfg.vss and senders:
            cgot = await self._collect(asm, MsgType.REGION_COMMIT,
                                       senders)
            my_point = committee.index(self.pid) + 1
            for h in sorted(senders):
                buf = cgot[h].astype(np.uint32, copy=False)
                r_h = len(region_of(h))
                if audit:
                    if buf.shape[0] != r_h * commit_words:
                        raise ProtocolError(
                            f"member {h} REGION_COMMIT carries "
                            f"{buf.shape[0]} words, expected "
                            f"{r_h * commit_words} (per-dealer)")
                    peer_dealer_commits[h] = buf.reshape(
                        r_h, d, deg + 1, 2)
                    peer_agg[h] = self._aggregate_commits(
                        peer_dealer_commits[h])
                else:
                    if buf.shape[0] != commit_words:
                        raise ProtocolError(
                            f"member {h} REGION_COMMIT carries "
                            f"{buf.shape[0]} words, expected "
                            f"{commit_words}")
                    peer_agg[h] = buf.reshape(d, deg + 1, 2)
                # the hardening rule (DESIGN.md §13): an incoming
                # regional sum must be a valid share, at this member's
                # own evaluation point, of the secret its region's
                # commitments bind — flip/replay/forgery all break the
                # pairing, and the blame lands on the sender
                ok = self._verify(
                    got[h].astype(np.uint32, copy=False)[None, :],
                    peer_agg[h], (my_point,))[0]
                if not ok.all():
                    bad.append(h)
            if bad:
                self.log(f"round {round_index}: blaming members {bad} "
                         "(REGION_SUM failed its region's commitments)")
                await self._send(Frame(
                    MsgType.BLAME, round=round_index, src=self.pid,
                    payload=codec.encode_json(
                        {"kind": "region", "blamed": bad,
                         "round": round_index})))
        # a condemned region is out of the round wholesale: its sum is
        # not folded and its dealers leave the divisor.  The corruption
        # is in the sender's frames, so every honest receiver reaches
        # the same verdict and the surviving rows stay consistent
        # shares of the same degraded sum (sub-threshold completion
        # instead of an all-members-blamed abort)
        acc = self._fold_all(
            [region_acc[self.pid]]
            + [got[h].astype(np.uint32, copy=False)
               for h in sorted(senders) if h not in bad], d)
        excluded = {p for h in bad for p in region_of(h)}
        l_eff = l - len(excluded)

        honest_acc = acc
        if not region_tamper:
            acc = self._apply_tamper(acc, round_index, d)
        self._prev_acc = honest_acc

        order = live_members
        my_idx = order.index(self.pid)
        k = len(order)
        if cfg.scheme == "additive":
            if my_idx > 0:
                got = await self._collect(asm, MsgType.CHAIN_SUM,
                                          {order[my_idx - 1]})
                acc = self._fold_all([acc, got[order[my_idx - 1]]], d)
            if my_idx < k - 1:
                await self._send_chunked(
                    MsgType.CHAIN_SUM, order[my_idx + 1],
                    round_index=round_index,
                    phase=Phase.PHASE2_EXCHANGE, arr=acc,
                    dtype_code=Wiredtype.UINT32)
                return
            member_sums = acc[None, :]
            points = None
        else:
            if my_idx < k - 1:
                await self._send_chunked(
                    MsgType.CHAIN_SUM, order[-1],
                    round_index=round_index,
                    phase=Phase.PHASE2_EXCHANGE, arr=acc,
                    dtype_code=Wiredtype.UINT32)
                return
            rows = {self.pid: acc}
            if k > 1:
                rows.update(await self._collect(
                    asm, MsgType.CHAIN_SUM, set(order[:-1])))
            good_inc = [p for p in included if p not in excluded]
            if audit:
                region_map = {h: region_of(h) for h in order}
                honest, rows = await self._audit_tree_dealers(
                    round_index, rows, order, committee, good_inc,
                    region_map, ingest, bad, asm, d)
                l_eff = len(honest)
            use_order = list(order)
            if cfg.vss:
                if audit:
                    # re-aggregate the per-dealer commitments over the
                    # honest dealers only — the group product over any
                    # dealer subset binds that subset's partial sums
                    dealer_commit = {}
                    for i, p in enumerate(region_inc):
                        dealer_commit[p] = my_dealer_commits[i]
                    for h in sorted(senders):
                        if h in bad:
                            continue
                        for i, p in enumerate(region_of(h)):
                            dealer_commit[p] = peer_dealer_commits[h][i]
                    agg_commits = self._aggregate_commits(
                        np.stack([dealer_commit[p] for p in honest]))
                else:
                    # the group product over the surviving regions'
                    # aggregates — commutative, so the per-region
                    # regrouping reproduces the hub's all-at-once
                    # aggregate exactly
                    parts = ([] if my_agg is None else [my_agg])
                    parts += [peer_agg[h] for h in sorted(senders)
                              if h not in bad]
                    if not parts:
                        raise ProtocolError(
                            "no regional commitments survived at the "
                            "final member — an empty included set "
                            "should have aborted upstream")
                    agg_commits = self._aggregate_commits(
                        np.stack(parts))
                use_order = await self._verify_member_rows(
                    round_index, rows, order, committee, agg_commits)
            member_sums = np.stack([rows[w] for w in use_order])
            points = (None if len(use_order) == len(committee) else
                      tuple(committee.index(w) + 1 for w in use_order))

        mean = self._reconstruct_mean(member_sums, l_eff, points=points)
        await self._send_chunked(
            MsgType.RESULT, -1, round_index=round_index,
            phase=Phase.WIRE_RESULT, arr=mean,
            dtype_code=Wiredtype.FLOAT32)

    async def _verify_member_rows(self, round_index: int, rows, order,
                                  committee, agg_commits) -> list:
        """Batch-verify every member row against the aggregate
        commitments; BLAME failing members; return the verified order.

        This is the detector of the VSS battery: a tampered partial
        sum (flipped bits / wrong polynomial / replayed round) cannot
        satisfy ``h^{row_w} == Π_j (Π_i C_{i,j})^{x_w^j}`` — the
        aggregate commitments bind this round's polynomials exactly.
        The caller supplies ``agg_commits`` (``[d, deg+1, 2]``): the hub
        final member aggregates every included dealer's commitments
        locally; the tree final member multiplies the per-region
        aggregates (REGION_COMMIT) — the group product is commutative,
        so both are bit-identical.
        """
        cfg = self.cfg
        deg = cfg.degree()
        points = tuple(committee.index(w) + 1 for w in order)
        ok = self._verify(np.stack([rows[w] for w in order]), agg_commits,
                          points)
        row_ok = ok.all(axis=1)
        blamed = [w for i, w in enumerate(order) if not row_ok[i]]
        if blamed:
            self.log(f"round {round_index}: blaming members {blamed} "
                     "(partial-sum verification failed)")
            await self._send(Frame(
                MsgType.BLAME, round=round_index, src=self.pid,
                payload=codec.encode_json(
                    {"kind": "member", "blamed": blamed,
                     "round": round_index})))
        good = [w for i, w in enumerate(order) if row_ok[i]]
        if len(good) < deg + 1:
            raise ProtocolError(
                f"only {len(good)} member rows verified but Shamir "
                f"degree {deg} needs {deg + 1}; blamed: {blamed}")
        return good

    # -- pre-round compile warm-up barrier (cfg.warmup) -------------------

    async def _warmup(self, frame: Frame) -> None:
        """Launch the round's kernels once on zero data, then ack.

        The coordinator sends the round's exact shapes before arming
        any stage monitor, so first use on the device (the CUDA
        context, the load of the kernel library) never burns the
        straggler deadline.  Unlike the reference's JIT warm-up, a
        failure here is not advisory: a kernel that cannot launch now
        cannot launch in the round, so the worker reports the error and
        exits (nothing falls back to the CPU).
        """
        self._warm_kernels(codec.decode_json(frame.payload))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        await self._send(Frame(MsgType.WARMUP_ACK, round=frame.round,
                               src=self.pid))

    def _warm_kernels(self, body: dict) -> None:
        cfg = self.cfg
        d = int(body["d"])
        ids = [int(p) for p in body.get("party_ids") or ()]
        committee = [int(w) for w in body.get("committee") or ()]
        home = {int(k): int(v)
                for k, v in (body.get("home") or {}).items()}
        m = len(committee)
        chunks = {min(cfg.chunk_elems, d)}
        if d % cfg.chunk_elems:
            chunks.add(d % cfg.chunk_elems)
        zeros = torch.zeros(max(chunks), dtype=torch.float32,
                            device=self.device)
        deg = cfg.degree()
        k0, k1 = philox.derive_key(cfg.seed, self.pid)
        if self.pid in ids:
            for ch in sorted(chunks):
                self.agg.make_shares_batch(
                    zeros[None, :ch], seed=cfg.seed,
                    party_ids=[self.pid], round_index=0, elem_base=0)
                if cfg.vss:
                    vss.feldman_commit(self.agg.encode(zeros[:ch]), k0,
                                       k1, degree=deg, counter_base=0)
        if not committee or self.pid not in committee:
            return
        l = len(ids)
        self._reconstruct_mean(np.zeros((m, d), np.uint32), max(1, l))
        if not cfg.vss:
            return
        my_point = committee.index(self.pid) + 1
        all_pts = tuple(range(1, m + 1))
        one_commit = np.ones((d, deg + 1, 2), dtype=np.uint32)
        if cfg.relay == "tree":
            r = len([p for p in ids if home.get(p) == self.pid])
            if r:
                # region dealer verify (all m points) + regional
                # commitment aggregation
                self._verify(np.zeros((m, r * d), np.uint32),
                             np.ones((r * d, deg + 1, 2), np.uint32),
                             all_pts)
                self._aggregate_commits(
                    np.ones((r, d, deg + 1, 2), np.uint32))
            # incoming REGION_SUM check at this member's own point
            self._verify(np.zeros((1, d), np.uint32), one_commit,
                         (my_point,))
        else:
            # hub dealer verify (own point, batched over l dealers) +
            # the final member's all-dealer aggregation
            self._verify(np.zeros((1, l * d), np.uint32),
                         np.ones((l * d, deg + 1, 2), np.uint32),
                         (my_point,))
            self._aggregate_commits(
                np.ones((max(1, l), d, deg + 1, 2), np.uint32))
        # final-member row check (cheap to warm on every member; only
        # the final live member will need it)
        self._verify(np.zeros((m, d), np.uint32), one_commit, all_pts)

    # -- main loop --------------------------------------------------------

    async def run(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        self._reader_task = asyncio.ensure_future(self._read_loop())
        # region listener (tree relay, DESIGN.md §13): opened before
        # HELLO because the relay mode is only known at WELCOME, and
        # the coordinator needs every *member*'s listener address in
        # hand when it builds the tree ROUND_START.  Bound to the same
        # interface the coordinator connection uses; port 0 = ephemeral.
        self._region_queue = asyncio.Queue()
        local = self.writer.get_extra_info("sockname")
        listen_host = local[0] if local else "127.0.0.1"
        self._region_server = await asyncio.start_server(
            self._accept_region, listen_host, 0)
        self._region_addr = (
            self._region_server.sockets[0].getsockname()[:2])
        await self._send(Frame(
            MsgType.HELLO, src=self.pid,
            payload=codec.encode_json(
                {"addr": list(self._region_addr)})))
        welcome = await self._next(MsgType.WELCOME)
        self.session = welcome.session
        self.cfg = WireConfig.from_json(codec.decode_json(welcome.payload))
        self.agg = self.cfg.aggregator(self.device)
        self.log(f"party {self.pid} joined federation "
                 f"(n={self.cfg.n}, scheme={self.cfg.scheme}, "
                 f"relay={self.cfg.relay})")
        try:
            while True:
                frame = await self._next(MsgType.ELECT,
                                         MsgType.ROUND_START,
                                         MsgType.WARMUP)
                if frame.msg_type == MsgType.ELECT:
                    await self._election_subround(frame)
                elif frame.msg_type == MsgType.WARMUP:
                    await self._warmup(frame)
                else:
                    await self._round(frame)
        except _Shutdown:
            self.log("shutdown requested")
        finally:
            self._reader_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._reader_task
            self.writer.close()
            self._region_server.close()
            for _, writer in self._region_out.values():
                with contextlib.suppress(Exception):
                    writer.close()

    async def _accept_region(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        """One inbound region stream (this member is someone's home).

        The first frame must be a HELLO naming the sender; every later
        frame is queued for the round's :class:`RegionIngest` with the
        HELLO's session id (authenticated there against the ROUND_START
        roster).  EOF queues an ``eof`` sentinel so the member can tell
        the coordinator about an upload that died mid-stream."""
        src = None
        try:
            hello = await read_frame(reader)
            if hello is None or hello.msg_type != MsgType.HELLO:
                return
            src = int(hello.src)
            self._region_seen.add(src)
            session = int(hello.session)
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                if int(frame.src) != src:
                    self.log(f"region stream from {src} carried a frame "
                             f"claiming src={frame.src}; closing")
                    break
                await self._region_queue.put(
                    ("frame", frame, session, writer))
        except (WireError, ConnectionError, OSError) as e:
            self.log(f"region stream from {src} died: {e}")
        finally:
            if src is not None:
                await self._region_queue.put(("eof", src, 0, None))
            with contextlib.suppress(Exception):
                writer.close()

    async def _region_conn(self, member: int, addr: tuple[str, int]):
        """Cached outbound connection to ``member``'s region listener;
        one HELLO (carrying this party's session lease) per
        connection."""
        key = (member, addr)
        cached = self._region_out.get(key)
        if cached is not None and not cached[1].is_closing():
            return cached
        try:
            reader, writer = await asyncio.open_connection(*addr)
            await write_frame(writer, Frame(
                MsgType.HELLO, src=self.pid, session=self.session))
        except (ConnectionError, OSError) as e:
            raise _RegionDead(member) from e
        self._region_out[key] = (reader, writer)
        return (reader, writer)

    async def _region_uplink(self, member: int | None, addrs: dict):
        """The upload ``send`` callable for the tree relay: this
        party's SHARE_UPLOAD/COMMITMENT frames go to its home member's
        region listener instead of the coordinator.  A member homed at
        itself short-circuits through its own region queue."""
        if member is None:
            raise ProtocolError(
                f"tree ROUND_START assigns no home member to party "
                f"{self.pid}")
        if member == self.pid:
            async def enqueue(frame: Frame) -> None:
                await self._region_queue.put(
                    ("frame", frame, self.session, None))
            return enqueue
        addr = addrs.get(member)
        if addr is None:
            raise ProtocolError(
                f"tree ROUND_START carries no region address for home "
                f"member {member}")
        _, writer = await self._region_conn(member, addr)

        async def send(frame: Frame) -> None:
            if self.session and frame.session == 0:
                frame = dataclasses.replace(frame, session=self.session)
            try:
                await write_frame(writer, frame)
            except (ConnectionError, OSError) as e:
                raise _RegionDead(member) from e
        return send

    async def fail(self, exc: BaseException) -> None:
        """Best-effort ERROR report before exiting."""
        try:
            await self._send(Frame(
                MsgType.ERROR, src=self.pid,
                payload=codec.encode_json(
                    {"error": f"{type(exc).__name__}: {exc}"})))
            await self.writer.drain()
        except Exception:
            pass


def _open_log(party_id: int, path: str | None):
    """``(log, record, fh)``: text lines and per-round JSON lines to
    the same file."""
    if path is None:
        log_dir = os.environ.get("REPRO_NET_LOG_DIR")
        if not log_dir:
            return lambda msg: None, lambda obj: None, None
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"party-{party_id}.log")
    fh = open(path, "a", buffering=1)

    def log(msg):
        fh.write(f"[party {party_id}] {msg}\n")

    def record(obj):
        fh.write(json.dumps(obj, sort_keys=True) + "\n")

    return log, record, fh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--party-id", type=int, required=True)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the party's math runs: cuda (the "
                         "default; raises without a card) or cpu")
    ap.add_argument("--die-after-upload", type=int, default=None,
                    help="TEST HOOK: exit abruptly after sending this "
                         "round's share uploads")
    ap.add_argument("--die-before-upload", type=int, default=None,
                    help="TEST HOOK: exit abruptly on this round's "
                         "ROUND_START, before any share frame — the "
                         "tree relay's probe-settled dropout")
    ap.add_argument("--tamper", choices=TAMPER_MODES, default=None,
                    help="TEST HOOK: corrupt this member's partial sum "
                         "(the VSS adversary)")
    ap.add_argument("--tamper-round", type=int, default=None,
                    help="round index the --tamper hook fires on")
    ap.add_argument("--poison", choices=DEALER_TAMPER_MODES, default=None,
                    help="TEST HOOK: poison this dealer's round input "
                         "(scale/sign_flip) or malform its share "
                         "stream (the scenario-harness adversary)")
    ap.add_argument("--poison-round", type=int, default=None,
                    help="round index the --poison hook fires on")
    args = ap.parse_args(argv)
    # no card for --device cuda raises here, before any connection
    device = dispatch.resolve_device(args.device)
    log, record, fh = _open_log(args.party_id, args.log_file)
    worker = PartyWorker(args.host, args.port, args.party_id,
                         die_after_upload=args.die_after_upload,
                         die_before_upload=args.die_before_upload,
                         tamper=args.tamper,
                         tamper_round=args.tamper_round,
                         poison=args.poison,
                         poison_round=args.poison_round, log=log,
                         device=device, record=record)

    async def _run():
        try:
            await worker.run()
            return 0
        except Exception as e:
            log("FATAL: " + "".join(traceback.format_exception(e)))
            if worker.writer is not None:
                await worker.fail(e)
            return 1

    code = asyncio.run(_run())
    if fh is not None:
        fh.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
