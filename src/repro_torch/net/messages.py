"""Logical-message layer: chunk reassembly and wire accounting.

A copy of ``repro/net/messages.py``.

A logical protocol message (one vote share, one model-share upload, one
broadcast) is streamed as a sequence of frames sharing ``(src, dst,
msg_type, round)`` whose ``chunk_off`` advances contiguously to
``total_elems``.  Two consumers sit on that stream:

* :class:`MessageAssembler` — reassembles payload chunks into one array
  (party side: inputs, uploads, chain sums, broadcasts).
* :class:`MessageMeter` — tracks completion *without* retaining payload
  (coordinator side) and feeds each completed logical message into the
  shared ``fl.transport.Network`` counters under its phase name, so the
  measured wire traffic is cross-checked against the paper's closed
  forms (Eqs. 1-8) by the same assertions the simulation uses.

Both enforce conformance: wrong-round frames, phase/type mismatches,
out-of-order or overlapping chunks, and mid-message metadata changes
raise :class:`~repro_torch.net.wire.ProtocolError` instead of corrupting
sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .codec import decode_array
from .wire import Frame, Phase, ProtocolError, Wiredtype

__all__ = ["MessageAssembler", "MessageMeter"]

#: msg types that carry counted data payloads (everything else is
#: control JSON and exempt from round/chunk conformance)
_DATA_PHASES = frozenset(Phase.COUNTER_NAMES)


def _key(frame: Frame):
    return (frame.src, frame.dst, frame.msg_type)


@dataclasses.dataclass
class _Progress:
    total: int
    phase: int
    dtype: int
    received: int = 0
    chunks: list | None = None          # None = metering only


def _feed(progress: dict, frame: Frame, *, round_index: int | None,
          keep_payload: bool, max_elems: int | None):
    """Shared conformance checks; returns the completed _Progress or
    ``None`` if the logical message still has chunks outstanding."""
    if frame.phase not in _DATA_PHASES:
        raise ProtocolError(
            f"{frame.type_name()} frame carries non-data phase "
            f"{frame.phase}")
    if round_index is not None and frame.round != round_index:
        raise ProtocolError(
            f"{frame.type_name()} frame for round {frame.round} arrived "
            f"during round {round_index}")
    if frame.dtype not in Wiredtype.ELEM_BYTES:
        raise ProtocolError(
            f"{frame.type_name()} frame has non-array dtype {frame.dtype}")
    if frame.total_elems == 0:
        # every counted protocol leg carries b or s elements, both >= 1
        # (and PhaseStats rejects zero-size messages for the same
        # reason) — a zero-element data message is a protocol violation
        raise ProtocolError(
            f"{frame.type_name()} declares a zero-element message")
    if max_elems is not None and frame.total_elems > max_elems:
        raise ProtocolError(
            f"{frame.type_name()} declares {frame.total_elems} elements, "
            f"above the {max_elems}-element message bound")
    key = _key(frame)
    st = progress.get(key)
    if st is None:
        st = progress[key] = _Progress(
            total=frame.total_elems, phase=frame.phase, dtype=frame.dtype,
            chunks=[] if keep_payload else None)
    if (frame.total_elems != st.total or frame.phase != st.phase
            or frame.dtype != st.dtype):
        raise ProtocolError(
            f"{frame.type_name()} metadata changed mid-message: "
            f"total/phase/dtype ({frame.total_elems}, {frame.phase}, "
            f"{frame.dtype}) vs ({st.total}, {st.phase}, {st.dtype})")
    if frame.chunk_off != st.received:
        raise ProtocolError(
            f"{frame.type_name()} chunk at offset {frame.chunk_off}, "
            f"expected {st.received} (out-of-order or overlapping chunk)")
    st.received += frame.elems
    if st.chunks is not None:
        st.chunks.append(frame.payload)
    if st.received < st.total:
        return None
    del progress[key]
    return st


class MessageAssembler:
    """Reassemble chunked logical messages into whole arrays.

    ``feed(frame)`` returns ``None`` while chunks are outstanding and
    the completed native-order 1-D array once ``total_elems`` arrived.
    """

    def __init__(self, *, round_index: int | None = None,
                 max_elems: int | None = None):
        self.round_index = round_index
        self.max_elems = max_elems
        self._progress: dict = {}

    def feed(self, frame: Frame) -> np.ndarray | None:
        st = _feed(self._progress, frame, round_index=self.round_index,
                   keep_payload=True, max_elems=self.max_elems)
        if st is None:
            return None
        arr = decode_array(st.dtype, b"".join(st.chunks))
        if arr.shape[0] != st.total:
            raise ProtocolError(
                f"assembled {arr.shape[0]} elements, header promised "
                f"{st.total}")
        return arr

    def pending(self) -> set:
        """Keys of messages with chunks outstanding."""
        return set(self._progress)

    def discard(self, src: int) -> None:
        """Drop partial messages from a dead/excluded sender."""
        for key in [k for k in self._progress if k[0] == src]:
            del self._progress[key]


class MessageMeter:
    """Count completed logical messages into a ``Network``.

    The coordinator relays frames between parties; the meter observes
    every relayed frame and, when a logical message completes, counts
    exactly one message of ``total_elems`` elements under the frame's
    phase counter — the wire twin of the simulation's
    ``Network.send``.  Payloads are not retained.
    """

    def __init__(self, net, *, round_index: int | None = None,
                 max_elems: int | None = None):
        self.net = net
        self.round_index = round_index
        self.max_elems = max_elems
        self._progress: dict = {}
        self.completed: int = 0

    def feed(self, frame: Frame) -> bool:
        """Returns True when ``frame`` completed a logical message."""
        st = _feed(self._progress, frame, round_index=self.round_index,
                   keep_payload=False, max_elems=self.max_elems)
        if st is None:
            return False
        self.net.send_batch(1, st.total, Phase.COUNTER_NAMES[st.phase])
        self.completed += 1
        return True

    def in_flight(self, src: int | None = None) -> set:
        keys = set(self._progress)
        if src is not None:
            keys = {k for k in keys if k[0] == src}
        return keys
