"""Length-prefixed binary wire format for the multi-process transport.

A copy of ``repro/net/wire.py`` (the port imports nothing of the
reference): the same frames byte for byte, so a party worker of either
package can join a round that the other's coordinator runs.

Every frame on a socket is::

    [ u32 length | 32-byte header | payload (length - 32 bytes) ]

with the header (big-endian, ``struct`` format ``HEADER_FMT``)::

    offset  field        type  meaning
    0       magic        2s    b"2P"
    2       version      u8    PROTOCOL_VERSION (2)
    3       msg_type     u8    MsgType code
    4       round        u32   aggregation round index
    8       phase        u8    Phase code (maps to Network counter names)
    9       scheme       u8    0 none | 1 additive | 2 shamir
    10      dtype        u8    0 raw bytes / JSON | 1 uint32 | 2 float32
    11      flags        u8    reserved, must be 0
    12      src          i32   logical sender party id (-1 = coordinator)
    16      dst          i32   logical receiver party id (-1 = coordinator)
    20      session      u32   registration-lease session id (0 = none;
                               assigned in WELCOME, carried on every
                               subsequent frame — DESIGN.md §12)
    24      chunk_off    u32   element offset of this chunk in the message
    28      total_elems  u32   logical message length in elements

A *logical message* (one share upload, one vote vector, one broadcast)
may span many frames: chunks of ``chunk_elems`` elements each carry
their ``chunk_off`` so 20M-parameter models never materialize in a
single frame.  Array payloads are little-endian (``<u4`` / ``<f4``);
the header is network byte order.

Malformed input raises a typed :class:`WireError` subclass — never
hangs, never returns garbage: truncated frames, oversized frames, bad
magic, unknown versions, dtype/payload mismatches and chunk-sequence
violations each have their own exception so the conformance suite
(``tests/test_torch_wire_protocol.py``) can pin the behaviour per failure
mode.  The frame layout is versioned: bumping ``PROTOCOL_VERSION``
invalidates peers loudly (``VersionError``) instead of corrupting math.
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct

__all__ = [
    "BadMagicError", "Frame", "FrameReader", "HEADER_SIZE", "MAGIC",
    "MAX_PAYLOAD_BYTES", "MsgType", "OversizedFrameError", "Phase",
    "PartyFailedError", "ProtocolError", "PROTOCOL_VERSION", "Scheme",
    "StaleSessionError", "TruncatedFrameError", "VersionError",
    "WireError", "WireTimeoutError",
    "Wiredtype", "encode_frame", "decode_frame", "read_frame",
    "write_frame",
]

MAGIC = b"2P"
PROTOCOL_VERSION = 2
HEADER_FMT = ">2sBBIBBBBiiIII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)          # 32
assert HEADER_SIZE == 32
_LEN = struct.Struct(">I")
_HEADER = struct.Struct(HEADER_FMT)

#: Hard per-frame payload bound — a streaming chunk of 2^20 uint32
#: elements is 4 MiB, so 8 MiB leaves headroom without letting a
#: malformed length prefix allocate unbounded memory.
MAX_PAYLOAD_BYTES = 8 << 20


class WireError(Exception):
    """Base class for every wire-protocol failure."""


class TruncatedFrameError(WireError):
    """Stream ended (or buffer ran out) in the middle of a frame."""


class OversizedFrameError(WireError):
    """Frame length prefix exceeds the configured payload bound."""


class BadMagicError(WireError):
    """First header bytes are not the protocol magic."""


class VersionError(WireError):
    """Peer speaks a different PROTOCOL_VERSION."""


class ProtocolError(WireError):
    """Well-formed frame violating the protocol state machine
    (wrong round, wrong phase, bad chunk sequence, unknown type)."""


class StaleSessionError(ProtocolError):
    """Frame carries a session id that is not the party's current
    registration lease — a reconnect after the lease expired (or after
    a fresh re-registration superseded it) must re-HELLO with session 0
    instead of resuming."""


class WireTimeoutError(WireError):
    """A stage deadline expired before the expected messages arrived."""


class PartyFailedError(WireError):
    """A remote party reported a fatal error (ERROR frame)."""


class MsgType:
    """Frame type codes (u8)."""

    HELLO = 1           # party -> coordinator: {party_id}
    WELCOME = 2         # coordinator -> party: federation config JSON
    ELECT = 3           # coordinator -> party: start election subround
    VOTE_SHARE = 4      # party -> party (relayed): b-vector vote share
    VOTE_PARTIAL = 5    # party -> party (relayed): b-vector partial sum
    COMMITTEE = 6       # party -> coordinator: committee report JSON
    ROUND_START = 7     # coordinator -> party: Phase II round config JSON
    INPUT = 8           # coordinator -> party: the party's flat update
    SHARE_UPLOAD = 9    # party -> committee member (relayed): share chunk
    CHAIN_SUM = 10      # member -> member (relayed): partial-sum chunk
    COMMIT = 11         # coordinator -> member: included party set JSON
    RESULT = 12         # final member -> coordinator: aggregated mean
    BROADCAST = 13      # coordinator (as member w) -> party: the mean
    SHUTDOWN = 14       # coordinator -> party: exit cleanly
    ERROR = 15          # party -> coordinator: fatal error JSON
    READY = 16          # member -> coordinator: upload duties done,
                        # alive and awaiting COMMIT (liveness gate)
    COMMITMENT = 17     # party -> committee member (relayed): Feldman
                        # commitment chunk (VSS; DESIGN.md §10)
    BLAME = 18          # member -> coordinator: verification-failure
                        # report JSON {kind, blamed, round}
    DEALER_ROWS = 19    # non-final member -> final member (relayed):
                        # per-dealer share rows for the norm-bound
                        # audit (DESIGN.md §11)
    UPLOAD_DONE = 20    # home member -> coordinator (tree relay): one
                        # region party's upload is fully held, JSON
                        # {party, round} (DESIGN.md §13)
    METER = 21          # home member -> coordinator (tree relay):
                        # region counter digest JSON for metering
                        # reconciliation {counters: {phase: [num, size]}}
    REGION_SUM = 22     # home member -> member (relayed, tree): the
                        # fold of its region's share rows addressed to
                        # the destination member's evaluation point
    REGION_COMMIT = 23  # home member -> every other member (relayed,
                        # tree): regional Feldman commitments — the
                        # pointwise product over the region's dealers,
                        # or the per-dealer concatenation when the
                        # norm-bound audit needs dealer granularity
    UPLOAD_PROBE = 24   # coordinator -> home member (tree relay): a
                        # region party's coordinator socket died — is
                        # its upload settled? JSON {party}.  The member
                        # answers UPLOAD_DONE{done:false} iff the party
                        # never reached the region listener (fail-fast
                        # upload verdict, DESIGN.md §13)
    WARMUP = 25         # coordinator -> party: pre-round compile
                        # warm-up barrier JSON {d, party_ids,
                        # committee, round} — the party JITs the
                        # round's exact kernel shapes before stage
                        # deadlines arm
    WARMUP_ACK = 26     # party -> coordinator: warm-up complete

    _NAMES = {}  # filled below


MsgType._NAMES = {v: k for k, v in vars(MsgType).items()
                  if isinstance(v, int)}


class Phase:
    """Phase codes (u8) — data phases map onto ``Network`` counters."""

    CONTROL = 0
    PHASE1 = 1              # election vote shares + partial sums
    PHASE2_UPLOAD = 2
    PHASE2_EXCHANGE = 3
    PHASE2_BROADCAST = 4
    WIRE_INPUT = 5          # driver -> party input shipping (hub artifact)
    WIRE_RESULT = 6         # final member -> coordinator (hub artifact)
    PHASE2_COMMIT = 7       # Feldman commitment broadcasts (VSS — the
                            # Eq. 5-6 extension, costmodel cross-check)
    PHASE2_AUDIT = 8        # per-dealer rows forwarded to the final
                            # member for the norm-bound audit (scenario
                            # harness — costmodel.phase2_audit_*)
    WIRE_REGION = 9         # tree-relay artifacts (REGION_SUM /
                            # REGION_COMMIT fan-in between members) —
                            # topology cost, outside Eqs. 1-8 like the
                            # other WIRE_* phases (DESIGN.md §13)

    #: Network counter name per phase code; WIRE_* phases are physical
    #: hub artifacts outside the paper's Eqs. 1-8 and are counted under
    #: their own names so the cross-checks can exclude them.
    COUNTER_NAMES = {
        PHASE1: "phase1",
        PHASE2_UPLOAD: "phase2_upload",
        PHASE2_EXCHANGE: "phase2_exchange",
        PHASE2_BROADCAST: "phase2_broadcast",
        WIRE_INPUT: "wire_input",
        WIRE_RESULT: "wire_result",
        PHASE2_COMMIT: "phase2_commit",
        PHASE2_AUDIT: "phase2_audit",
        WIRE_REGION: "wire_region",
    }


class Scheme:
    NONE = 0
    ADDITIVE = 1
    SHAMIR = 2

    CODES = {"additive": ADDITIVE, "shamir": SHAMIR}
    NAMES = {ADDITIVE: "additive", SHAMIR: "shamir"}


class Wiredtype:
    """Payload dtype codes (u8)."""

    RAW = 0        # uninterpreted bytes (JSON control payloads)
    UINT32 = 1     # little-endian uint32 elements
    FLOAT32 = 2    # little-endian float32 elements

    ELEM_BYTES = {UINT32: 4, FLOAT32: 4}


@dataclasses.dataclass(frozen=True)
class Frame:
    """One decoded wire frame (header + raw payload bytes)."""

    msg_type: int
    round: int = 0
    phase: int = Phase.CONTROL
    scheme: int = Scheme.NONE
    dtype: int = Wiredtype.RAW
    src: int = -1
    dst: int = -1
    session: int = 0
    chunk_off: int = 0
    total_elems: int = 0
    payload: bytes = b""

    @property
    def elems(self) -> int:
        """Number of elements carried by this frame's payload."""
        per = Wiredtype.ELEM_BYTES.get(self.dtype)
        return len(self.payload) // per if per else 0

    def type_name(self) -> str:
        return MsgType._NAMES.get(self.msg_type, f"type{self.msg_type}")


def encode_frame(frame: Frame) -> bytes:
    """Serialize a frame: length prefix + header + payload."""
    payload = frame.payload
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise OversizedFrameError(
            f"payload {len(payload)} bytes exceeds the "
            f"{MAX_PAYLOAD_BYTES}-byte frame bound — chunk the message")
    header = _HEADER.pack(
        MAGIC, PROTOCOL_VERSION, frame.msg_type, frame.round & 0xFFFFFFFF,
        frame.phase, frame.scheme, frame.dtype, 0, frame.src, frame.dst,
        frame.session & 0xFFFFFFFF, frame.chunk_off, frame.total_elems)
    return _LEN.pack(HEADER_SIZE + len(payload)) + header + payload


def _parse_header(buf: bytes) -> Frame:
    (magic, version, msg_type, rnd, phase, scheme, dtype, _flags, src,
     dst, session, chunk_off, total_elems) = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise BadMagicError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != PROTOCOL_VERSION:
        raise VersionError(
            f"peer speaks protocol version {version}, this build speaks "
            f"{PROTOCOL_VERSION}")
    payload = bytes(buf[HEADER_SIZE:])
    per = Wiredtype.ELEM_BYTES.get(dtype)
    if per is not None and len(payload) % per != 0:
        raise ProtocolError(
            f"dtype {dtype} payload of {len(payload)} bytes is not a "
            f"multiple of {per}")
    frame = Frame(msg_type=msg_type, round=rnd, phase=phase, scheme=scheme,
                  dtype=dtype, src=src, dst=dst, session=session,
                  chunk_off=chunk_off, total_elems=total_elems,
                  payload=payload)
    if per is not None and frame.chunk_off + frame.elems > total_elems:
        raise ProtocolError(
            f"{frame.type_name()} chunk [{chunk_off}, "
            f"{chunk_off + frame.elems}) overruns total_elems="
            f"{total_elems}")
    return frame


def decode_frame(data: bytes,
                 max_payload: int = MAX_PAYLOAD_BYTES) -> tuple[Frame, int]:
    """Decode one frame from the head of ``data``.

    Returns ``(frame, bytes_consumed)``.  Raises
    :class:`TruncatedFrameError` if ``data`` does not hold a complete
    frame — callers with streaming input should use :class:`FrameReader`
    instead, which treats that as "need more bytes".
    """
    if len(data) < _LEN.size:
        raise TruncatedFrameError(
            f"{len(data)} bytes cannot hold a length prefix")
    (frame_len,) = _LEN.unpack_from(data)
    if frame_len < HEADER_SIZE:
        raise TruncatedFrameError(
            f"frame length {frame_len} is shorter than the "
            f"{HEADER_SIZE}-byte header")
    if frame_len > HEADER_SIZE + max_payload:
        raise OversizedFrameError(
            f"frame length {frame_len} exceeds the "
            f"{HEADER_SIZE + max_payload}-byte bound")
    end = _LEN.size + frame_len
    if len(data) < end:
        raise TruncatedFrameError(
            f"buffer holds {len(data)} bytes of a {end}-byte frame")
    return _parse_header(data[_LEN.size:end]), end


class FrameReader:
    """Sans-IO incremental frame parser.

    ``feed(data)`` returns every frame completed by the new bytes;
    partial frames are buffered (never blocks, never busy-waits).
    ``eof()`` raises :class:`TruncatedFrameError` if the stream ended
    mid-frame, so a killed peer is always a typed error, not a hang.
    """

    def __init__(self, max_payload: int = MAX_PAYLOAD_BYTES):
        self._buf = bytearray()
        self.max_payload = max_payload

    def feed(self, data: bytes) -> list[Frame]:
        self._buf += data
        frames = []
        while True:
            try:
                frame, used = decode_frame(bytes(self._buf),
                                           self.max_payload)
            except TruncatedFrameError:
                return frames
            del self._buf[:used]
            frames.append(frame)

    def eof(self) -> None:
        if self._buf:
            raise TruncatedFrameError(
                f"stream ended with {len(self._buf)} buffered bytes of an "
                "incomplete frame")


async def read_frame(reader: asyncio.StreamReader,
                     max_payload: int = MAX_PAYLOAD_BYTES) -> Frame | None:
    """Read one frame; ``None`` on clean EOF at a frame boundary."""
    prefix = await reader.read(_LEN.size)
    if not prefix:
        return None
    while len(prefix) < _LEN.size:
        more = await reader.read(_LEN.size - len(prefix))
        if not more:
            raise TruncatedFrameError("EOF inside a frame length prefix")
        prefix += more
    (frame_len,) = _LEN.unpack(prefix)
    if frame_len < HEADER_SIZE:
        raise TruncatedFrameError(
            f"frame length {frame_len} is shorter than the header")
    if frame_len > HEADER_SIZE + max_payload:
        raise OversizedFrameError(
            f"frame length {frame_len} exceeds the bound")
    try:
        body = await reader.readexactly(frame_len)
    except asyncio.IncompleteReadError as e:
        raise TruncatedFrameError(
            f"EOF after {len(e.partial)} of {frame_len} frame bytes"
        ) from e
    return _parse_header(body)


async def write_frame(writer: asyncio.StreamWriter, frame: Frame,
                      lock: asyncio.Lock | None = None) -> int:
    """Encode + write one frame (whole-frame atomic under ``lock``)."""
    data = encode_frame(frame)
    if lock is None:
        writer.write(data)
        await writer.drain()
    else:
        async with lock:
            writer.write(data)
            await writer.drain()
    return len(data)
