"""Member-side region fan-in for the committee-sharded relay tree.

Counterpart of ``repro/net/region.py``, on the port's ``Network``.

In ``relay="tree"`` (DESIGN.md §13) each cohort party streams its
SHARE_UPLOAD (and, under VSS, COMMITMENT) chunks straight to its *home*
committee member's region listener instead of through the coordinator
hub.  :class:`RegionIngest` is the home member's receiving state
machine for one round, kept free of sockets so it unit-tests like
``PartyRegistry`` and ``StageMonitor``:

* **authentication** — every region frame must carry the sender's
  current session id from the coordinator's ROUND_START roster; a
  mismatch is a typed :class:`StaleSessionError` (the caller answers
  with an ERROR frame, exactly like the coordinator's per-frame gate);
* **reassembly** — chunks reassemble through the same
  :class:`MessageAssembler` the party side uses, so reconnect/resume
  works on member sockets too (progress is keyed by logical message
  ``(src, dst, type)``, not by connection);
* **metering** — every completed logical message is counted into a
  local ``fl.transport.Network`` under its phase name.  The member
  ships :meth:`digest` to the coordinator post-COMMIT (a METER frame),
  which replays it via ``Network.absorb`` — that reconciliation keeps
  the Eq. 3–6 counters bit-identical to the sim even though the
  region's frames never crossed the coordinator's socket.
"""

from __future__ import annotations

import numpy as np

from repro_torch.fl.transport import Network

from .messages import MessageAssembler, MessageMeter
from .wire import Frame, MsgType, ProtocolError, StaleSessionError

__all__ = ["RegionIngest"]

#: the only message types a region listener accepts — everything else
#: (control, votes, chain traffic) still belongs to the coordinator
REGION_TYPES = frozenset({MsgType.SHARE_UPLOAD, MsgType.COMMITMENT})


class RegionIngest:
    """One round's upload fan-in at a home committee member.

    Args:
      round_index: the aggregation round these uploads belong to.
      roster: ``{pid: session}`` — the coordinator's current leases for
        the round's participants (from the ROUND_START body); region
        frames authenticate against it.
      expect_msgs: logical messages that constitute one party's
        complete upload — ``m`` share rows, plus ``m`` commitment
        streams under VSS.
    """

    def __init__(self, *, round_index: int, roster: dict,
                 expect_msgs: int, max_elems: int | None = None):
        if expect_msgs < 1:
            raise ValueError(
                f"expect_msgs={expect_msgs} must be >= 1")
        self.round_index = int(round_index)
        self.roster = {int(p): int(s) for p, s in roster.items()}
        self.expect_msgs = int(expect_msgs)
        self.net = Network()
        self._asm = MessageAssembler(round_index=self.round_index,
                                     max_elems=max_elems)
        self._meter = MessageMeter(self.net, round_index=self.round_index,
                                   max_elems=max_elems)
        #: completed share rows, ``(dealer, dst_member) -> uint32[d]``
        self.rows: dict[tuple[int, int], np.ndarray] = {}
        #: completed commitment streams, same keying (VSS only)
        self.commits: dict[tuple[int, int], np.ndarray] = {}
        self._done_msgs: dict[int, int] = {}
        #: parties whose full upload is held
        self.done: set[int] = set()

    def feed(self, frame: Frame, session: int) -> int | None:
        """Ingest one region frame; returns the party id when this
        frame completed that party's *entire* upload (the member then
        reports UPLOAD_DONE to the coordinator), else ``None``.

        Raises :class:`StaleSessionError` for an unknown sender or a
        session that is not the sender's current lease, and
        :class:`ProtocolError` for non-upload message types or chunk
        conformance violations — same failure taxonomy as the hub path.
        """
        if frame.msg_type not in REGION_TYPES:
            raise ProtocolError(
                f"{frame.type_name()} frame on a region listener — only "
                "SHARE_UPLOAD/COMMITMENT travel the tree")
        src = int(frame.src)
        expected = self.roster.get(src)
        if expected is None:
            raise StaleSessionError(
                f"party {src} is not in round {self.round_index}'s "
                "roster — not a participant, or registered after "
                "ROUND_START")
        if int(session) != expected:
            raise StaleSessionError(
                f"party {src} presented session {int(session):#x} on the "
                f"region listener; its current lease is {expected:#x}")
        arr = self._asm.feed(frame)
        self._meter.feed(frame)
        if arr is None:
            return None
        store = (self.rows if frame.msg_type == MsgType.SHARE_UPLOAD
                 else self.commits)
        store[(src, int(frame.dst))] = arr
        got = self._done_msgs.get(src, 0) + 1
        self._done_msgs[src] = got
        if got < self.expect_msgs:
            return None
        if got > self.expect_msgs:
            raise ProtocolError(
                f"party {src} sent {got} upload messages, expected "
                f"{self.expect_msgs}")
        self.done.add(src)
        return src

    def complete(self, pids) -> bool:
        """True when every pid's full upload is held."""
        return set(int(p) for p in pids) <= self.done

    def in_flight(self, src: int | None = None) -> set:
        """Logical messages with chunks outstanding (resume window)."""
        return {k for k in self._asm.pending()
                if src is None or k[0] == src}

    def discard(self, src: int) -> None:
        """Drop a sender's partial messages (e.g. its stream died and
        the coordinator excluded it)."""
        self._asm.discard(src)
        for key in list(self._meter.in_flight(src)):
            del self._meter._progress[key]

    def digest(self) -> dict:
        """``{phase: [msg_num, msg_size]}`` of every *completed*
        logical message — the METER payload the coordinator replays
        through ``Network.absorb`` (partial uploads are not counted,
        matching the hub meter's completion-only accounting)."""
        return {phase: [st.msg_num, st.msg_size]
                for phase, st in self.net.phases.items()}
