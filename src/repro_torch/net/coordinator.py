"""Asyncio TCP coordinator: Algs. 2 + 3 over real sockets.

Counterpart of ``repro/net/coordinator.py``.  The coordinator relays,
meters and elects; it stays on the host (its oracle election, cohort
draw and home map run on the CPU) while the party workers do the share
math on their own devices.

The coordinator is the *physical* hub of the deployment — parties keep
one TCP connection each — while the *logical* protocol stays the
paper's: vote shares and partial sums travel party→party (relayed,
``src``/``dst`` in the frame header), model shares travel
party→committee member, the committee chains partial sums, and the
aggregate is broadcast back.  A :class:`~repro_torch.net.messages.MessageMeter`
observes every relayed logical message and counts it into the shared
``fl.transport.Network`` under the paper's phase names, so the measured
wire traffic is cross-checked against Eqs. 1–8 with the *same*
assertions the counting simulation uses.  Hub artifacts that the paper
does not count (driver→party input shipping, final-member→coordinator
result return, JSON control frames) are deliberately outside those
counters (``wire_input`` / ``wire_result`` / uncounted).

Fault handling: a party's EOF is a deterministic dropout; a connected
party that misses a stage deadline (injectable clock,
``timeouts.StageMonitor``) is a straggler.  Observed fault sets feed
``fl.faults.resolve_outcome`` — the same quorum/committee logic the
simulation uses — and the round proceeds over survivors (Shamir
sub-threshold reconstruction) or aborts exactly where the simulation
would raise.

Ordering invariant (load-bearing): a relayed frame is written to its
destination *before* it is metered, and stage decisions (COMMIT, chain
kickoff) are only made from metered state and written afterwards on the
same per-party sockets — TCP ordering then guarantees a member has
every relayed share of an included party before its COMMIT arrives.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses

import numpy as np

from repro_torch.core import committee as committee_mod
from repro_torch.fl.cohort import assign_home, sample_cohort
from repro_torch.fl.faults import resolve_outcome, resolve_region_blames
from repro_torch.fl.transport import Network

from . import codec
from .config import WireConfig
from .messages import MessageAssembler, MessageMeter
from .registry import PartyRegistry
from .timeouts import StageMonitor, SystemClock
from .wire import (HEADER_SIZE, Frame, MsgType, PartyFailedError, Phase,
                   ProtocolError, Scheme, StaleSessionError, WireError,
                   WireTimeoutError, Wiredtype, read_frame, write_frame)

__all__ = ["Coordinator", "RelayDropped"]

#: poll granularity of deadline checks (real-clock runs); manual-clock
#: state-machine tests never sleep — they drive StageMonitor directly
_POLL_S = 0.05

#: METER digests may only reconcile the legs that actually travel the
#: tree (region uploads + commitments) — a member claiming to have
#: metered, say, phase1 traffic is lying about legs the coordinator
#: witnesses itself
_DIGEST_PHASES = frozenset({"phase2_upload", "phase2_commit"})


@dataclasses.dataclass(frozen=True)
class RelayDropped:
    """One undeliverable relayed logical stream: the destination's
    connection was dead or absent when a frame for it arrived.  Keyed
    per ``(src, dst, msg_type, round)`` in ``Coordinator.relay_dropped``
    (a Counter of frames), so tests and operators see exactly which leg
    went dark instead of a silent ``return``."""

    src: int
    dst: int
    msg_type: int
    round: int


class _Conn:
    """One connected party."""

    def __init__(self, pid: int, reader, writer, addr=None):
        self.pid = pid
        self.reader = reader
        self.writer = writer
        self.lock = asyncio.Lock()
        self.alive = True
        self.task: asyncio.Task | None = None
        #: the party's advertised region-listener ``(host, port)`` —
        #: carried in the HELLO payload; home members must have one
        #: before a tree-relay round can start
        self.addr: tuple[str, int] | None = addr


class Coordinator:
    """TCP server orchestrating two-phase MPC rounds over ``n`` parties."""

    def __init__(self, cfg: WireConfig, *, net: Network | None = None,
                 clock=None, log=None):
        self.cfg = cfg
        self.net = net if net is not None else Network()
        self.clock = clock if clock is not None else SystemClock()
        self.log = log or (lambda msg: None)
        #: registration leases + session ids (DESIGN.md §12); session
        #: ids are minted at HELLO/WELCOME and validated on every frame
        self.registry = PartyRegistry(cfg.n, lease_s=cfg.lease_s)
        self.committee: tuple[int, ...] | None = None
        self.election_rounds: int | None = None
        #: the current round's sampled cohort (cohort mode; global ids)
        self.cohort_ids: tuple[int, ...] | None = None
        #: ``(stage, round) -> (start, end)`` clock times — the
        #: pipelining proof: phase1[r+1] must start before phase2[r]
        #: ends (asserted by the overlap tests)
        self.stage_times: dict[tuple[str, int], tuple[float, float]] = {}
        #: in-flight speculative election for the next round:
        #: ``(round_index, cohort_ids, task)``
        self._pipelined: tuple[int, tuple[int, ...],
                               asyncio.Task] | None = None
        #: members caught tampering by the VSS layer (never re-elected)
        self.evicted: set[int] = set()
        #: per-party election weight for the per-round re-election
        self.reputation: dict[int, float] = {}
        self._elected_round: int | None = None
        self._round_blamed: set[int] = set()
        #: dealers the final member's norm-bound audit blamed this
        #: round (kind="poison" BLAME — DESIGN.md §11)
        self._round_blamed_dealers: set[int] = set()
        #: the round's included (upload-complete) party set — the only
        #: parties a poison BLAME may legitimately name
        self._round_included: list[int] = []
        #: the only party whose member-BLAME is accepted this round
        #: (the final live member — it runs the row verification)
        self._verifier: int | None = None
        self.raw_bytes_in = 0
        self.raw_bytes_out = 0
        #: subset of raw bytes whose frames carry a counted data phase
        #: (``Phase.COUNTER_NAMES``) — the per-link closed forms in
        #: ``core.costmodel`` price exactly these, excluding JSON
        #: control chatter whose size is serialization-dependent
        self.data_bytes_in = 0
        self.data_bytes_out = 0
        #: undeliverable relayed streams (typed; satellite of the
        #: silent-drop fix): ``RelayDropped -> frame count``
        self.relay_dropped: collections.Counter = collections.Counter()
        #: tree relay (DESIGN.md §13): this round's home-member map,
        #: the parties whose uploads died with their home member, and
        #: the members whose METER digests have been reconciled
        self._round_home: dict[int, int] = {}
        self._region_lost: set[int] = set()
        self._round_digests: set[int] = set()
        #: region-BLAME tally: ``accused -> {accusers}`` — receiving
        #: members accuse the *sender* of a REGION_SUM that fails its
        #: regional commitments; condemnation needs the strict
        #: majority of ``fl.faults.resolve_region_blames`` so a single
        #: malicious receiver cannot frame an honest sender
        self._region_accusations: dict[int, set[int]] = {}
        #: the in-flight aggregation round (UPLOAD_PROBE stamping)
        self._round_index: int | None = None
        #: parties that acked this round's WARMUP barrier
        self._warm_acks: set[int] = set()
        self._server: asyncio.Server | None = None
        self._conns: dict[int, _Conn] = {}
        self._event = asyncio.Event()
        #: one meter per in-flight round (the pipelined election for
        #: round r+1 meters concurrently with round r's Phase II)
        self._meters: dict[int, MessageMeter] = {}
        self._result: MessageAssembler | None = None
        self._result_mean: np.ndarray | None = None
        self._committee_reports: dict[int, list | None] = {}
        self._ready: set[int] = set()
        self._upload_done: dict[int, int] = {}
        self._party_error: str | None = None
        self._round_dropped: set[int] = set()
        self._monitors: list[StageMonitor] = []
        self._upload_mon: StageMonitor | None = None

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._server is not None, "coordinator not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._accept, host, port)
        self.log(f"coordinator listening on {host}:{self.port}")
        return self.port

    async def stop(self) -> None:
        if self._pipelined is not None:
            self._pipelined[2].cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._pipelined[2]
            self._pipelined = None
        for conn in list(self._conns.values()):
            if conn.alive:
                with contextlib.suppress(Exception):
                    await self._send(conn.pid, Frame(MsgType.SHUTDOWN))
        for conn in list(self._conns.values()):
            if conn.task is not None:
                conn.task.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await conn.task
            with contextlib.suppress(Exception):
                conn.writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def wait_for_parties(self, timeout_s: float = 60.0) -> None:
        """Block until all ``n`` parties have completed HELLO/WELCOME."""
        def ready():
            return len(self._conns) >= self.cfg.n
        await self._wait(ready, timeout_s,
                         what=f"{self.cfg.n}-party registration")

    # -- connection handling ---------------------------------------------

    async def _accept(self, reader, writer):
        try:
            hello = await read_frame(reader)
        except WireError as e:
            self.log(f"handshake failed: {e}")
            writer.close()
            return
        if hello is None or hello.msg_type != MsgType.HELLO:
            self.log("connection without HELLO; dropping")
            writer.close()
            return
        pid = hello.src
        prev = self._conns.get(pid)
        if not 0 <= pid < self.cfg.n or (prev is not None and prev.alive):
            self.log(f"rejecting HELLO from invalid/duplicate party {pid}")
            writer.close()
            return
        now = self.clock.monotonic()
        if hello.session:
            # reconnect: resume the existing lease mid-federation — the
            # party keeps its session id and logical identity; meter/
            # assembler progress is keyed by (src, dst, type), so an
            # interrupted logical message continues where the old
            # socket broke.  A stale session is a typed, *reported*
            # rejection: the party learns it must re-register fresh.
            try:
                session = self.registry.resume(pid, hello.session, now)
            except StaleSessionError as e:
                self.log(f"party {pid} resume rejected: {e}")
                with contextlib.suppress(Exception):
                    await write_frame(writer, Frame(
                        MsgType.ERROR, dst=pid,
                        payload=codec.encode_json({"error": str(e)})))
                    writer.close()
                return
            verb = "resumed"
        else:
            session = self.registry.register(pid, now)
            verb = "registered"
        # party workers advertise their region-listener address in the
        # HELLO payload (tree relay); raw-socket parties and older
        # peers send an empty payload and simply cannot serve as home
        # members — the tree round start checks, not the handshake
        addr = None
        if hello.payload:
            with contextlib.suppress(Exception):
                advertised = codec.decode_json(hello.payload).get("addr")
                if advertised:
                    addr = (str(advertised[0]), int(advertised[1]))
        conn = _Conn(pid, reader, writer, addr=addr)
        self._conns[pid] = conn
        await write_frame(writer, Frame(
            MsgType.WELCOME, dst=pid, session=session,
            payload=codec.encode_json(self.cfg.to_json())), conn.lock)
        conn.task = asyncio.ensure_future(self._serve(conn))
        self.log(f"party {pid} {verb} (session {session:#x}, "
                 f"{len(self._conns)}/{self.cfg.n})")
        self._pulse()

    async def _serve(self, conn: _Conn) -> None:
        """Per-party read loop: relay, meter, surface control frames."""
        try:
            while True:
                frame = await read_frame(conn.reader)
                if frame is None:
                    break
                nbytes = 4 + HEADER_SIZE + len(frame.payload)
                self.raw_bytes_in += nbytes
                if frame.phase in Phase.COUNTER_NAMES:
                    self.data_bytes_in += nbytes
                await self._on_frame(conn, frame)
        except (WireError, ConnectionError, asyncio.IncompleteReadError,
                OSError) as e:
            self.log(f"party {conn.pid} stream error: {e!r}")
        finally:
            self._mark_dead(conn)

    def _mark_dead(self, conn: "_Conn | None") -> None:
        """EOF/error on ``conn``; a superseded connection (its pid
        resumed or re-registered on a fresh socket) dies silently —
        only the *current* connection's death is a party dropout."""
        if conn is None or not conn.alive:
            return
        conn.alive = False
        # release the socket now: the server's wait_closed() (Python
        # >= 3.12.1) waits for every connection it accepted, and stop()
        # closes only the current one of each party, not one superseded
        # by a re-registration or a resume
        with contextlib.suppress(Exception):
            conn.writer.close()
        if self._conns.get(conn.pid) is conn:
            self._round_dropped.add(conn.pid)
            defer = self._defer_upload_verdict(conn.pid)
            for mon in self._monitors:
                if defer and mon is self._upload_mon:
                    continue
                mon.eof(conn.pid)
            self.log(f"party {conn.pid} disconnected (EOF)")
            if defer:
                self._probe_home(conn.pid)
            self._lose_region(conn.pid)
        self._pulse()

    def _probe_home(self, pid: int) -> None:
        """Fail-fast upload verdict for a deferred EOF (tree relay).

        ``pid``'s coordinator socket died but its upload verdict lives
        with its home member — probe it NOW instead of waiting for the
        stage deadline.  The member answers UPLOAD_DONE{done:false}
        only for a party it *never saw* on its region listener; a
        party that did connect settles through its own region stream
        (queued frames complete it, or the EOF sentinel reports the
        death), so the probe cannot contradict in-flight evidence."""
        home = self._round_home.get(pid)
        if home is None or self._round_index is None:
            return
        asyncio.ensure_future(self._send(home, Frame(
            MsgType.UPLOAD_PROBE, round=self._round_index, dst=home,
            payload=codec.encode_json({"party": pid}))))

    def _defer_upload_verdict(self, pid: int) -> bool:
        """Tree relay: a participant's coordinator-socket EOF proves
        nothing about its upload — those frames went to its home
        member.  When the home member is alive and the verdict is still
        open, leave the upload stage pending: the home member settles it
        deterministically with UPLOAD_DONE (complete — the frames beat
        the FIN on the region socket's FIFO) or UPLOAD_DONE{done:false}
        (its region stream died incomplete).  A party that died before
        ever reaching its home member is settled by the coordinator's
        own UPLOAD_PROBE (``_probe_home``): the member answers a
        fail-fast dropout verdict for a party it never saw, so tree
        EOF handling matches the hub's immediacy; the stage deadline
        remains only as the backstop for the connect/probe race."""
        if self.cfg.relay != "tree" or not self._round_home:
            return False
        home = self._round_home.get(pid)
        if home is None or pid in self._region_lost:
            return False
        if self._upload_done.get(pid, 0) == self.cfg.m:
            return False     # verdict already in; eof would be a no-op
        conn = self._conns.get(home)
        return conn is not None and conn.alive

    def _lose_region(self, member: int) -> None:
        """Tree relay: a dead home member takes its region's uploads
        with it.  The lost parties fold into the *upload* monitor as
        deterministic dropouts — fail-fast, no deadline wait — and are
        excluded from the included set, degrading the round to the
        sub-threshold reconstruction path over the surviving regions.
        (Only the upload stage is affected: a still-alive party homed
        at the dead member keeps its committee/broadcast roles.)"""
        if not self._round_home:
            return
        lost = {p for p, h in self._round_home.items()
                if h == member and p not in self._region_lost}
        if not lost:
            return
        self._region_lost |= lost
        self.log(f"home member {member} lost; region {sorted(lost)} "
                 "uploads die with it (sub-threshold degradation)")
        if self._upload_mon is not None:
            for p in lost:
                self._upload_mon.eof(p)

    async def _on_frame(self, conn: _Conn, frame: Frame) -> None:
        if frame.src != conn.pid:
            raise ProtocolError(
                f"party {conn.pid} spoofed src={frame.src}")
        # session gate: every post-HELLO frame must carry the party's
        # current lease; a superseded session is typed
        # (StaleSessionError) and costs the sender its connection,
        # never the round it no longer belongs to.  Expiry is NOT
        # enforced here — a frame on the live socket is liveness
        # evidence (a party mid-JIT can be silent past lease_s), so the
        # frame renews the lease instead of tripping over it
        now = self.clock.monotonic()
        self.registry.validate(conn.pid, frame.session, now,
                               enforce_expiry=False)
        self.registry.renew(conn.pid, now)
        if frame.dst >= 0:
            # party->party data: relay FIRST, then meter — the ordering
            # invariant every COMMIT/chain decision depends on
            if frame.dst >= self.cfg.n:
                raise ProtocolError(
                    f"relay to out-of-range party {frame.dst}")
            await self._relay(frame)
            meter = self._meters.get(frame.round)
            if meter is None:
                raise ProtocolError(
                    f"{frame.type_name()} data frame outside any round")
            if meter.feed(frame):
                self._note_completion(frame)
            self._pulse()
            return
        # control / result traffic addressed to the coordinator
        if frame.msg_type == MsgType.COMMITTEE:
            report = codec.decode_json(frame.payload)
            self._committee_reports[conn.pid] = report.get("committee")
        elif frame.msg_type == MsgType.READY:
            self._ready.add(conn.pid)
        elif frame.msg_type == MsgType.RESULT:
            meter = self._meters.get(frame.round)
            if self._result is None or meter is None:
                raise ProtocolError("RESULT outside an aggregation round")
            done = self._result.feed(frame)
            meter.feed(frame)
            if done is not None:
                self._result_mean = done
        elif frame.msg_type == MsgType.WARMUP_ACK:
            self._warm_acks.add(conn.pid)
        elif frame.msg_type == MsgType.UPLOAD_DONE:
            self._on_upload_done(conn, frame)
        elif frame.msg_type == MsgType.METER:
            self._on_meter(conn, frame)
        elif frame.msg_type == MsgType.BLAME:
            self._on_blame(conn.pid, frame)
        elif frame.msg_type == MsgType.ERROR:
            info = codec.decode_json(frame.payload)
            self._party_error = (f"party {conn.pid} failed: "
                                 f"{info.get('error')}")
            self.log(self._party_error)
        else:
            raise ProtocolError(
                f"unexpected {frame.type_name()} addressed to the "
                "coordinator")
        self._pulse()

    def _on_blame(self, pid: int, frame: Frame) -> None:
        """Validate + fold a BLAME report.

        Blame is powerful (it evicts parties from every future
        election), so the coordinator accepts it only from the party
        the protocol designates as the verifier of that evidence —
        anything else is a typed ``ProtocolError`` that costs the
        *reporter* its connection, never the accused: a single
        malicious worker must not be able to brick the federation by
        naming honest parties.
        """
        report = codec.decode_json(frame.payload)
        try:
            kind = report.get("kind")
            blamed = {int(w) for w in report.get("blamed", [])}
        except (TypeError, ValueError, AttributeError) as e:
            raise ProtocolError(
                f"malformed BLAME payload from party {pid}: {e}")
        committee = set(self.committee or ())
        if (kind not in ("member", "dealer", "poison", "region")
                or not blamed):
            raise ProtocolError(
                f"BLAME from party {pid} with kind={kind!r} and "
                f"blamed={sorted(blamed)}")
        if not blamed <= set(range(self.cfg.n)):
            raise ProtocolError(
                f"BLAME from party {pid} names out-of-range parties "
                f"{sorted(blamed - set(range(self.cfg.n)))}")
        if kind == "member":
            # only the round's designated verifier (the final live
            # member, which holds every partial-sum row) may blame
            # members, and only committee members can be blamed
            if pid != self._verifier:
                raise ProtocolError(
                    f"party {pid} sent a member BLAME but the round's "
                    f"verifier is {self._verifier}")
            if not blamed <= committee:
                raise ProtocolError(
                    f"member BLAME names non-committee parties "
                    f"{sorted(blamed - committee)}")
            self._round_blamed |= blamed
            self.log(f"member {pid} blames members {sorted(blamed)} "
                     f"(round {frame.round})")
        elif kind == "poison":
            # only the round's verifier (the final member — it alone
            # reconstructs the per-dealer sums) may blame poisoned
            # dealers, and only included dealers can be blamed; unlike
            # kind="dealer" this is non-fatal — the verifier excludes
            # the poisoned updates and the round completes clean
            if pid != self._verifier:
                raise ProtocolError(
                    f"party {pid} sent a poison BLAME but the round's "
                    f"verifier is {self._verifier}")
            if not blamed <= set(self._round_included):
                raise ProtocolError(
                    f"poison BLAME names non-included parties "
                    f"{sorted(blamed - set(self._round_included))}")
            self._round_blamed_dealers |= blamed
            self.log(f"member {pid} blames dealers {sorted(blamed)} "
                     f"for poisoned updates (round {frame.round})")
        elif kind == "region":
            # tree relay (DESIGN.md §13): a receiving member's
            # commitment check failed on an incoming REGION_SUM and it
            # accuses the *sender*.  Any committee member may accuse
            # (each verifies the sums it receives), but one accuser
            # condemns nobody — condemnation needs the strict majority
            # resolved at round end (fl.faults.resolve_region_blames),
            # so a malicious receiver cannot frame an honest sender.
            if pid not in committee:
                raise ProtocolError(
                    f"non-member party {pid} sent a region BLAME")
            if not blamed <= committee:
                raise ProtocolError(
                    f"region BLAME names non-committee parties "
                    f"{sorted(blamed - committee)}")
            if pid in blamed:
                raise ProtocolError(
                    f"party {pid} sent a region BLAME naming itself")
            for w in blamed:
                self._region_accusations.setdefault(w, set()).add(pid)
            self.log(f"member {pid} accuses {sorted(blamed)} of "
                     f"tampered REGION_SUMs (round {frame.round})")
        else:
            # a dealer whose share fails its own commitments is
            # protocol-fatal: members cannot unilaterally shrink the
            # included set, so the round aborts loudly.  Any committee
            # member may report it (each verifies its own shares).
            if pid not in committee:
                raise ProtocolError(
                    f"non-member party {pid} sent a dealer BLAME")
            self._party_error = (
                f"member {pid} blames dealer(s) {sorted(blamed)}: "
                "share verification failed before the member sum")
            self.log(self._party_error)

    def _on_upload_done(self, conn: _Conn, frame: Frame) -> None:
        """A home member holds one region party's complete upload.

        Tree twin of the hub meter's SHARE_UPLOAD completion: the
        coordinator includes a party only after its home member's
        UPLOAD_DONE, and the member sends it only after holding the
        full upload — so (TCP FIFO on the member's socket) a COMMIT
        naming the party is causally after the member can fold it, the
        tree-mode form of the hub's relay-before-meter invariant."""
        if self.cfg.relay != "tree":
            raise ProtocolError(
                f"UPLOAD_DONE from party {conn.pid} outside tree relay "
                "mode")
        info = codec.decode_json(frame.payload)
        try:
            pid = int(info.get("party"))
        except (TypeError, ValueError) as e:
            raise ProtocolError(
                f"malformed UPLOAD_DONE from member {conn.pid}: {e}")
        if self._round_home.get(pid) != conn.pid:
            raise ProtocolError(
                f"member {conn.pid} reported UPLOAD_DONE for party "
                f"{pid}, whose home member is "
                f"{self._round_home.get(pid)}")
        if not info.get("done", True):
            # the party's region stream died with its upload incomplete
            # — a deterministic upload-stage dropout reported by the
            # only node that can know (the hub learns the same thing
            # from the party's own EOF)
            self.log(f"member {conn.pid}: party {pid} upload died "
                     "incomplete on the region socket")
            if (self._upload_mon is not None
                    and pid not in self._region_lost):
                self._upload_mon.eof(pid)
            return
        self._upload_done[pid] = self.cfg.m
        if (self._upload_mon is not None
                and pid not in self._region_lost):
            self._upload_mon.completed(pid)

    def _on_meter(self, conn: _Conn, frame: Frame) -> None:
        """Reconcile a home member's region counter digest into the
        shared ``Network`` — the metering half of the tree relay: the
        region's logical messages never crossed the coordinator socket,
        but their Eq. 3–6 accounting must land on the same counters the
        sim asserts against."""
        if self.cfg.relay != "tree":
            raise ProtocolError(
                f"METER from party {conn.pid} outside tree relay mode")
        if conn.pid not in set(self.committee or ()):
            raise ProtocolError(
                f"METER digest from non-member party {conn.pid}")
        counters = codec.decode_json(frame.payload).get("counters")
        if not isinstance(counters, dict):
            raise ProtocolError(
                f"malformed METER payload from member {conn.pid}")
        for phase_name, entry in counters.items():
            if phase_name not in _DIGEST_PHASES:
                raise ProtocolError(
                    f"member {conn.pid} digest meters phase "
                    f"{phase_name!r}; only {sorted(_DIGEST_PHASES)} "
                    "travel the tree")
            try:
                msg_num, msg_size = (int(entry[0]), int(entry[1]))
                self.net.absorb(msg_num, msg_size, phase_name)
            except (TypeError, ValueError, IndexError) as e:
                raise ProtocolError(
                    f"bad METER digest entry {phase_name}={entry!r} "
                    f"from member {conn.pid}: {e}")
        self._round_digests.add(conn.pid)

    def _note_completion(self, frame: Frame) -> None:
        if frame.msg_type == MsgType.SHARE_UPLOAD:
            done = self._upload_done.get(frame.src, 0) + 1
            self._upload_done[frame.src] = done
            if done == self.cfg.m and self._upload_mon is not None:
                # only the upload stage completes here — a member's
                # READY (liveness gate) is a separate signal, so a
                # party that dies right after uploading is still a
                # deterministic member dropout
                self._upload_mon.completed(frame.src)

    async def _relay(self, frame: Frame) -> None:
        dst = self._conns.get(frame.dst)
        if dst is None or not dst.alive:
            # delivery impossible: the logical message stays metered
            # (the paper's Eqs. 3–6 count attempted sends) but the drop
            # is recorded under a typed counter and the destination is
            # folded into every active stage monitor NOW — peers
            # waiting on the destination's reply see a deterministic
            # dropout instead of blocking until the stage deadline
            self.relay_dropped[RelayDropped(
                frame.src, frame.dst, frame.msg_type, frame.round)] += 1
            self.log(f"relay dropped: {frame.type_name()} "
                     f"{frame.src}->{frame.dst} (round {frame.round}): "
                     "destination dead or never connected")
            for mon in self._monitors:
                mon.eof(frame.dst)
            self._pulse()
            return
        try:
            nbytes = await write_frame(dst.writer, frame, dst.lock)
            self.raw_bytes_out += nbytes
            if frame.phase in Phase.COUNTER_NAMES:
                self.data_bytes_out += nbytes
        except (ConnectionError, OSError):
            self._mark_dead(dst)

    async def _send(self, pid: int, frame: Frame) -> None:
        conn = self._conns.get(pid)
        if conn is None or not conn.alive:
            return
        if frame.session == 0:
            # stamp the destination's current lease so parties can see
            # which registration epoch a coordinator frame belongs to
            session = self.registry.session_of(pid)
            if session is not None:
                frame = dataclasses.replace(frame, session=session)
        try:
            nbytes = await write_frame(conn.writer, frame, conn.lock)
            self.raw_bytes_out += nbytes
            if frame.phase in Phase.COUNTER_NAMES:
                self.data_bytes_out += nbytes
        except (ConnectionError, OSError):
            self._mark_dead(conn)

    async def _send_chunked(self, pid: int, msg_type: int, *, round_index,
                            phase: int, dtype: int, arr: np.ndarray,
                            src: int = -1) -> None:
        for frame in codec.chunk_frames(
                msg_type, arr, round_index=round_index, phase=phase,
                scheme=Scheme.CODES.get(self.cfg.scheme, 0),
                dtype_code=dtype, src=src, dst=pid,
                chunk_elems=self.cfg.chunk_elems):
            await self._send(pid, frame)

    # -- waiting ----------------------------------------------------------

    def _pulse(self) -> None:
        self._event.set()

    def _check_party_error(self) -> None:
        if self._party_error is not None:
            raise PartyFailedError(self._party_error)

    async def _wait(self, cond, timeout_s: float | None, *, what: str,
                    monitor: StageMonitor | None = None) -> None:
        """Wait for ``cond()``; fold deadline expiry into ``monitor``."""
        t0 = self.clock.monotonic()
        while True:
            self._check_party_error()
            if monitor is not None:
                monitor.check()
            if cond():
                return
            if monitor is not None and monitor.settled():
                return
            if (timeout_s is not None
                    and self.clock.monotonic() - t0 > timeout_s):
                raise WireTimeoutError(f"timed out waiting for {what}")
            self._event.clear()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._event.wait(), _POLL_S)

    def _live(self, ids) -> list[int]:
        return [i for i in ids
                if i in self._conns and self._conns[i].alive]

    def _new_monitor(self, expected) -> StageMonitor:
        """Create+register a stage monitor, replaying known dropouts.

        Registered *before* any stage frames are sent so an EOF landing
        mid-stage is never lost; parties already dead are folded in
        immediately (their EOF event predates the monitor).
        """
        mon = StageMonitor(expected, self.cfg.deadline_s,
                           self.clock).start()
        for pid in list(mon.expected):
            conn = self._conns.get(pid)
            if conn is None or not conn.alive:
                mon.eof(pid)
        self._monitors.append(mon)
        return mon

    # -- Phase I: committee election (Alg. 2) -----------------------------

    def _round_cohort(self, round_index: int,
                      eligible=None) -> tuple[int, ...]:
        """Sample the round's cohort from the eligible pool (cohort
        mode) — the *same* ``sample_cohort`` draw the sim transport,
        the FedAvg driver, and the Eq. 3–6 mirror compute, which is
        what keeps sim and wire bit-identical per cohort."""
        pool = (self.registry.eligible(self.clock.monotonic())
                if eligible is None else {int(i) for i in eligible})
        pool -= self.evicted
        return sample_cohort(pool, self.cfg.cohort, self.cfg.seed,
                             round_index, device="cpu")

    async def elect(self, round_index: int = 0,
                    eligible=None) -> tuple[int, ...]:
        """Run Phase I over the wire and commit its result.

        Full-registry mode: every registered party votes.  Cohort mode
        (``cfg.cohort``): the round's cohort is sampled from
        ``eligible`` (default: the registry's live leases) minus
        evicted parties and the election runs among cohort members
        only.  A speculative election started by the previous round's
        pipelining is adopted here iff it ran over the identical
        cohort — its vote traffic is already on the Eq. 3 counters, so
        a membership change that invalidates the speculation is a loud
        ``ProtocolError`` instead of a silent double-count.
        """
        voters = None
        if self.cfg.cohort is not None:
            voters = self._round_cohort(round_index, eligible)
        if self._pipelined is not None:
            pipe_round, pipe_voters, task = self._pipelined
            self._pipelined = None
            if pipe_round == round_index and pipe_voters == voters:
                committee, subrounds = await task
            else:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError,
                                         Exception):
                    await task
                raise ProtocolError(
                    f"pipelined election for round {pipe_round} ran "
                    f"over cohort {pipe_voters} but round "
                    f"{round_index} needs {voters}: membership changed "
                    "mid-round (ban/eviction/churn) — its Phase I "
                    "traffic is already counted, so pipelining "
                    "requires round-stable membership (disable "
                    "pipeline= under adversarial churn)")
        else:
            committee, subrounds = await self._elect_wire(round_index,
                                                          voters)
        self.committee = tuple(committee)
        self.election_rounds = subrounds
        self.cohort_ids = voters
        self._elected_round = round_index
        self.log(f"committee elected: {self.committee} "
                 f"({subrounds} subround(s)"
                 + (f", cohort {voters}" if voters is not None else "")
                 + ")")
        return self.committee

    async def _elect_wire(self, round_index: int, voters) -> tuple:
        """One wire election over ``voters`` (None = full registry);
        returns ``(committee, subrounds)`` without committing state —
        the pipelined path runs this concurrently with the previous
        round's Phase II and commits only on adoption."""
        cfg = self.cfg
        if voters is None:
            live = self._live(range(cfg.n))
            if len(live) < cfg.n:
                raise WireError(
                    f"election needs all {cfg.n} parties connected, "
                    f"have {len(live)} (Alg. 2 elects over the full "
                    "membership)")
        else:
            live = self._live(voters)
            if len(live) < len(voters):
                raise WireError(
                    f"election needs every cohort member connected: "
                    f"cohort {tuple(voters)}, missing "
                    f"{sorted(set(voters) - set(live))} (Alg. 2 has "
                    "no quorum path)")
            live = sorted(voters)
        self._meters.setdefault(
            round_index, MessageMeter(self.net, round_index=round_index))
        t0 = self.clock.monotonic()
        subround = 0
        # eviction/reputation state rides the ELECT body so every party
        # applies the identical filter/weighting (unanimity check below)
        elect_state = {}
        if self.evicted:
            elect_state["exclude"] = sorted(self.evicted)
        if self.reputation:
            elect_state["weights"] = {str(k): v for k, v
                                      in sorted(self.reputation.items())}
        if voters is not None:
            elect_state["cohort"] = list(voters)
        created = []
        try:
            while True:
                self._committee_reports = {}
                mon = self._new_monitor(live)
                created.append(mon)
                for pid in live:
                    await self._send(pid, Frame(
                        MsgType.ELECT, round=round_index, dst=pid,
                        payload=codec.encode_json(
                            {"subround": subround, **elect_state})))

                def reported(mon=mon):
                    for pid in live:
                        if pid in self._committee_reports:
                            mon.completed(pid)
                    return len(self._committee_reports) == len(live)

                await self._wait(
                    reported, None,
                    what=f"election subround {subround} reports",
                    monitor=mon)
                if mon.dropped or mon.straggled:
                    raise WireError(
                        f"party failure during election: dropped="
                        f"{sorted(mon.dropped)} straggled="
                        f"{sorted(mon.straggled)} — election has no "
                        "quorum path (Alg. 2 needs every party's votes)")
                reports = set(
                    tuple(r or ())
                    for r in (self._committee_reports[pid]
                              for pid in live))
                if len(reports) != 1:
                    raise ProtocolError(
                        f"parties disagree on the committee: {reports}")
                committee = reports.pop()
                subround += 1
                if len(committee) == cfg.m:
                    break
                if subround >= 8:
                    raise WireError(
                        f"election failed to fill a committee of "
                        f"{cfg.m} in {subround} subrounds")
        finally:
            for mon in created:
                if mon in self._monitors:
                    self._monitors.remove(mon)
        self.stage_times[("phase1", round_index)] = (
            t0, self.clock.monotonic())
        # conformance cross-check: the wire election must agree with the
        # in-sim oracle (same seeds => same draws => same committee)
        if voters is None:
            oracle = committee_mod.elect(cfg.n, cfg.m, cfg.b,
                                         cfg.seed + round_index,
                                         exclude=self.evicted,
                                         reputation=self.reputation
                                         or None, device="cpu")
        else:
            oracle = committee_mod.elect_among(
                voters, cfg.m, cfg.b, cfg.seed + round_index,
                exclude=self.evicted,
                reputation=self.reputation or None, device="cpu")
        if tuple(committee) != oracle.committee:
            raise ProtocolError(
                f"wire election produced {committee}, oracle says "
                f"{oracle.committee}")
        if subround != oracle.rounds:
            raise ProtocolError(
                f"wire election used {subround} subrounds, oracle used "
                f"{oracle.rounds}")
        return tuple(committee), subround

    # -- Phase II: committee aggregation (Alg. 3) -------------------------

    async def aggregate(self, round_index: int, flats: np.ndarray,
                        party_ids: list[int], *, eligible=None,
                        pipeline_next_eligible=None):
        """One aggregation round; returns ``(mean [d], RoundOutcome)``.

        Cohort mode: the round runs over ``round_index``'s sampled
        cohort (electing it first if the driver has not already);
        ``party_ids`` must be cohort members.  With ``cfg.pipeline``,
        ``pipeline_next_eligible`` (the membership expected for round
        ``round_index + 1``) kicks off the next round's Phase I while
        this round's Phase II uploads are still streaming — the
        speculative result is adopted by the next ``elect()`` call.
        """
        cfg = self.cfg
        if cfg.cohort is not None:
            # cohort mode implies per-round election over the round's
            # sampled cohort (mirrors TwoPhaseTransport exactly)
            if self._elected_round != round_index:
                await self.elect(round_index, eligible=eligible)
        elif self.committee is None or (cfg.reelect_each_round
                                        and self._elected_round
                                        != round_index):
            # per-epoch re-election (Alg. 2 re-run): evicted members
            # are excluded, faulted ones reputation-weighted — mirrors
            # TwoPhaseTransport.reelect_each_round exactly
            await self.elect(round_index)
        flats = np.ascontiguousarray(np.asarray(flats, dtype=np.float32))
        ids = [int(i) for i in party_ids]
        if cfg.cohort is not None:
            stray = set(ids) - set(self.cohort_ids or ())
            if stray:
                raise ValueError(
                    f"party_ids {sorted(stray)} are not in round "
                    f"{round_index}'s sampled cohort {self.cohort_ids} "
                    "— only cohort members upload")
        if flats.shape[0] != len(ids):
            raise ValueError(
                f"{flats.shape[0]} updates but {len(ids)} party ids")
        d = int(flats.shape[1])
        # all raise-able validation BEFORE wire traffic: a rejected
        # round must not corrupt the Eqs. 5-6 counters (sim contract)
        if d == 0:
            raise ValueError(
                "cannot aggregate zero-length updates over the wire "
                "(zero-element messages are protocol violations)")
        cfg.fp().validate_for_parties(len(ids))

        members = set(ids)
        self._round_dropped = set()
        self._round_blamed = set()
        self._round_blamed_dealers = set()
        self._round_included = []
        self._verifier = None
        self._ready = set()
        self._upload_done = {}
        self._round_home = {}
        self._region_lost = set()
        self._round_digests = set()
        self._region_accusations = {}
        self._round_index = round_index
        self._warm_acks = set()
        self._result_mean = None
        self._meters.setdefault(
            round_index, MessageMeter(self.net, round_index=round_index))
        self._result = MessageAssembler(round_index=round_index)
        if self._pipelined is None:
            # stale-monitor hygiene between rounds; skipped while a
            # pipelined election's own monitor is still registered
            self._monitors = []
        t0_phase2 = self.clock.monotonic()
        round_monitors = []

        participants = self._live(ids)
        pre_dead = sorted(set(ids) - set(participants))
        if pre_dead:
            self.log(f"parties {pre_dead} already dead at round start")
            self._round_dropped |= set(pre_dead)

        if cfg.warmup:
            # pre-round compile warm-up barrier: every live party JITs
            # the round's exact kernel shapes on dummy data BEFORE any
            # stage monitor arms, so first-use compilation (Feldman
            # gpow ladders, per-point-set verify_shares recompiles)
            # never burns the straggler deadline.  No deadline on the
            # acks — the barrier exists precisely to absorb unbounded
            # JIT time; a party dying mid-warm-up is tolerated (its
            # EOF shrinks the ack set the barrier waits for).
            warm_body = {"d": d, "party_ids": ids,
                         "committee": list(self.committee)}
            if cfg.relay == "tree":
                warm_body["home"] = {
                    str(p): h for p, h in assign_home(
                        ids, self.committee, cfg.seed,
                        round_index, device="cpu").items()}
            warm_payload = codec.encode_json(warm_body)
            t0_warm = self.clock.monotonic()
            warm_ids = self._live(range(cfg.n))
            for pid in warm_ids:
                await self._send(pid, Frame(
                    MsgType.WARMUP, round=round_index, dst=pid,
                    payload=warm_payload))

            def warmed():
                live_now = {p for p in warm_ids
                            if p in self._conns
                            and self._conns[p].alive}
                return live_now <= self._warm_acks

            await self._wait(warmed, None, what="warm-up acks")
            self.stage_times[("warmup", round_index)] = (
                t0_warm, self.clock.monotonic())

        # stage monitors registered BEFORE any stage frame goes out so
        # a mid-stage EOF is never missed
        upload_mon = self._upload_mon = self._new_monitor(participants)
        member_mon = self._new_monitor(self._live(self.committee))
        round_monitors += [upload_mon, member_mon]

        tree_body = {}
        if cfg.relay == "tree":
            # the home map is the same deterministic Philox draw every
            # party worker recomputes from the ROUND_START body — sent
            # explicitly so members need no trust in their own math to
            # agree with the coordinator's UPLOAD_DONE validation
            self._round_home = assign_home(ids, self.committee,
                                           cfg.seed, round_index,
                                           device="cpu")
            addrs = {}
            for w in dict.fromkeys(self.committee):
                conn = self._conns.get(w)
                if conn is not None and conn.alive:
                    if conn.addr is None:
                        raise WireError(
                            f"relay='tree' needs member {w}'s region "
                            "listener address, but its HELLO advertised "
                            "none (raw-socket peers cannot serve as "
                            "home members)")
                    addrs[str(w)] = list(conn.addr)
                else:
                    # a member dead before round start takes its region
                    # down before any upload is attempted
                    self._lose_region(w)
            tree_body = {
                "home": {str(p): h
                         for p, h in self._round_home.items()},
                "addrs": addrs,
                # region listeners authenticate upload frames against
                # the parties' current leases (RegionIngest roster)
                "sessions": {str(p): self.registry.session_of(p)
                             for p in participants
                             if self.registry.session_of(p) is not None},
            }

        # 1) ROUND_START to every connected party (members must take
        #    part even when the driver excluded them as data parties)
        start_body = codec.encode_json({
            "party_ids": ids, "committee": list(self.committee),
            "d": d, "round": round_index, **tree_body})
        for pid in self._live(range(cfg.n)):
            await self._send(pid, Frame(
                MsgType.ROUND_START, round=round_index, dst=pid,
                payload=start_body))
        # 2) ship each participant its flat update (hub artifact: the
        #    driver owns the federation's data in this reproduction)
        row = {pid: k for k, pid in enumerate(ids)}
        for pid in participants:
            await self._send_chunked(
                pid, MsgType.INPUT, round_index=round_index,
                phase=Phase.WIRE_INPUT, dtype=Wiredtype.FLOAT32,
                arr=flats[row[pid]])
            self.net.send_batch(1, d, "wire_input")

        if (cfg.pipeline and cfg.cohort is not None
                and pipeline_next_eligible is not None):
            # pipelining (DESIGN.md §12): round r+1's Phase I election
            # starts NOW, while round r's Phase II uploads are still
            # streaming; the next elect() call adopts the result iff
            # the cohort it sampled matches (round-stable membership)
            next_voters = self._round_cohort(round_index + 1,
                                             pipeline_next_eligible)
            task = asyncio.ensure_future(
                self._elect_wire(round_index + 1, next_voters))
            self._pipelined = (round_index + 1, next_voters, task)
            self.log(f"pipelined Phase I for round {round_index + 1} "
                     f"over cohort {next_voters}")

        # 3) wait for uploads (n·m logical messages) + member READY
        await self._wait(lambda: False, None, what="share uploads",
                         monitor=upload_mon)

        def members_ready():
            for w in member_mon.expected:
                if w in self._ready:
                    member_mon.completed(w)
            return member_mon.settled()

        await self._wait(members_ready, None, what="member READY",
                         monitor=member_mon)
        upload_mon.require_any_progress()

        # 4) fault resolution through the simulation's quorum brain;
        #    a dead home member's region is data-dropped with it even
        #    where an UPLOAD_DONE had already landed — the member died
        #    holding the only copy of those uploads
        dropped = (self._round_dropped | upload_mon.dropped
                   | member_mon.dropped | self._region_lost) & members
        straggled = (upload_mon.straggled | member_mon.straggled) & members
        # a party flagged late whose upload nevertheless completed
        # before COMMIT is aggregated (the committee sums exactly the
        # share sets it received) — it must not be reported straggled,
        # or the (mean, outcome) pair would contradict itself
        straggled -= {pid for pid in participants
                      if self._upload_done.get(pid, 0) == cfg.m}
        outcome = resolve_outcome(
            members, dropped, straggled,
            committee=[w for w in self.committee if w in members],
            reconstruct_threshold=(cfg.reconstruct_threshold()
                                   if set(self.committee) <= members
                                   else None),
            resurrect=False)

        # members that answered READY and still hold a live socket
        live_members = [w for w in self.committee
                        if w in self._ready
                        and w in self._conns and self._conns[w].alive]
        if not live_members:
            raise WireTimeoutError("no live committee members")
        # the final live member assembles every partial-sum row, so it
        # is the round's designated verifier — the only party whose
        # member-BLAME reports are accepted (see _on_blame)
        self._verifier = live_members[-1]
        included = sorted((pid for pid in participants
                           if self._upload_done.get(pid, 0) == cfg.m
                           and pid not in self._region_lost),
                          key=row.get)
        if not included:
            raise WireTimeoutError("no party completed its upload")
        self._round_included = list(included)

        # 5) COMMIT: members fold exactly this set, then chain
        commit_body = codec.encode_json({
            "included": included, "live_members": live_members,
            "l": len(included)})
        chain_mon = self._new_monitor(live_members)
        round_monitors.append(chain_mon)
        for w in live_members:
            await self._send(w, Frame(
                MsgType.COMMIT, round=round_index, dst=w,
                payload=commit_body))

        await self._wait(lambda: self._result_mean is not None, None,
                         what="committee chain + RESULT",
                         monitor=chain_mon)
        if self._result_mean is None:
            raise WireTimeoutError(
                f"committee chain failed: dropped="
                f"{sorted(chain_mon.dropped)} straggled="
                f"{sorted(chain_mon.straggled)}")
        mean = self._result_mean
        if cfg.relay == "tree":
            # every live member's METER digest precedes its region sums
            # and chain traffic on its own FIFO socket, and RESULT
            # causally depends on all of those — so by the time the
            # mean assembled, reconciliation must be complete
            missing = set(live_members) - self._round_digests
            if missing:
                raise ProtocolError(
                    f"tree metering reconciliation incomplete: live "
                    f"members {sorted(missing)} never shipped a METER "
                    "digest before the RESULT assembled")

        if self._region_accusations:
            # every accuser's region BLAME precedes its CHAIN_SUM on
            # its own FIFO socket and the RESULT causally depends on
            # those sums, so by now the tally is complete — resolve
            # the strict-majority quorum.  A condemned member's
            # REGION_SUM was excluded wholesale by the receivers, so
            # its region's dealers never entered the fold: they are
            # reported dropped (data out of the round) alongside the
            # member's own blame.
            condemned = resolve_region_blames(
                self._region_accusations, live_members)
            if condemned:
                self._round_blamed |= condemned
                lost = {p for p, h in self._round_home.items()
                        if h in condemned
                        and p in set(included)} - condemned
                dropped |= lost
                self.log(f"region quorum condemns {sorted(condemned)}; "
                         f"their region dealers {sorted(lost)} are out "
                         "of the round")
        if self._round_blamed or self._round_blamed_dealers:
            # the verifier's BLAME landed before its RESULT (same
            # socket, FIFO): re-fold the outcome with the blamed sets —
            # blamed members/dealers are out of the round, never
            # resurrected, and evicted from every future election
            blamed = self._round_blamed & members
            outcome = resolve_outcome(
                members, dropped, straggled,
                committee=[w for w in self.committee if w in members],
                reconstruct_threshold=(cfg.reconstruct_threshold()
                                       if set(self.committee) <= members
                                       else None),
                resurrect=False, blamed=blamed,
                blamed_dealers=self._round_blamed_dealers & members)
        for w in self._round_blamed | self._round_blamed_dealers:
            self.evicted.add(w)
            self.reputation[w] = 0.0
        if cfg.reelect_each_round:
            # reputation only steers the per-round re-election (mirrors
            # TwoPhaseTransport._finish_outcome)
            for w in outcome.dropped:
                self.reputation[w] = self.reputation.get(w, 1.0) * 0.5

        # 6) broadcast: member w serves parties i ≡ w−1 (mod m)
        #    (Alg. 3 l.22); the paper counts all n broadcasts — dead
        #    parties' messages are attempted (counted) but undeliverable
        for pid in range(cfg.n):
            serving = self.committee[pid % len(self.committee)]
            self.net.send_batch(1, d, "phase2_broadcast")
            if pid in self._conns and self._conns[pid].alive:
                await self._send_chunked(
                    pid, MsgType.BROADCAST, round_index=round_index,
                    phase=Phase.PHASE2_BROADCAST, dtype=Wiredtype.FLOAT32,
                    arr=mean, src=serving)

        # scoped cleanup: only THIS round's monitors/meter go away (a
        # pipelined election for round r+1 may still be running with
        # its own monitor + meter registered)
        for mon in round_monitors:
            if mon in self._monitors:
                self._monitors.remove(mon)
        self._upload_mon = None
        self._meters.pop(round_index, None)
        self._result = None
        self.stage_times[("phase2", round_index)] = (
            t0_phase2, self.clock.monotonic())
        self.log(f"round {round_index}: l={len(included)} "
                 f"live_members={live_members} outcome={outcome}")
        return mean, outcome
