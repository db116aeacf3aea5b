"""Payload codecs: arrays, JSON control bodies, pytrees, chunking.

Counterpart of ``repro/net/codec.py``.  The encoders take numpy arrays
or torch tensors on any device and always produce bytes on the host; a
tensor of 32-bit words (``int64`` values in ``[0, 2^32)`` or ``int32``
bit patterns, ``core.field``) encodes as ``uint32``.  ``host_u32`` and
``device_words`` move words between the wire's ``uint32`` arrays and
the port's carriers.

Array payloads are little-endian on the wire (``<u4`` / ``<f4``) and
round-trip **bit-identically**: uint32 share codewords are exact by
construction, and float32 payloads are reinterpreted, never re-rounded
(NaN payload bits survive).  The pytree codec serializes a nested
dict/list/tuple of arrays as a JSON structure header followed by the
concatenated leaf bytes — enough to ship model states and means whole.
``tests/test_torch_wire_protocol.py`` pins the round-trips.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .wire import ProtocolError, Wiredtype

__all__ = [
    "chunk_frames", "decode_array", "decode_json", "decode_pytree",
    "device_words", "encode_array", "encode_json", "encode_pytree",
    "host_u32", "iter_chunks", "np_dtype_for",
]

#: wire dtype code -> little-endian numpy dtype
_NP_DTYPES = {
    Wiredtype.UINT32: np.dtype("<u4"),
    Wiredtype.FLOAT32: np.dtype("<f4"),
}
_WIRE_CODES = {
    np.dtype(np.uint32): Wiredtype.UINT32,
    np.dtype(np.float32): Wiredtype.FLOAT32,
}


def np_dtype_for(dtype_code: int) -> np.dtype:
    try:
        return _NP_DTYPES[dtype_code]
    except KeyError:
        raise ProtocolError(f"unknown wire dtype code {dtype_code}")


def wire_code_for(dtype) -> int:
    try:
        return _WIRE_CODES[np.dtype(dtype).newbyteorder("=")]
    except KeyError:
        raise ProtocolError(f"dtype {dtype} is not wire-encodable")


def host_u32(words) -> np.ndarray:
    """32-bit words (a tensor in either carrier, on any device, or a
    numpy array) as a host ``uint32`` array: one copy from the card."""
    if isinstance(words, torch.Tensor):
        words = words.detach()
        if words.dtype == torch.int64:
            return (words & 0xFFFFFFFF).cpu().numpy().astype(np.uint32)
        if words.dtype != torch.int32:
            raise ProtocolError(f"{words.dtype} tensor is not 32-bit words")
        return words.cpu().numpy().view(np.uint32)
    return np.asarray(words).astype(np.uint32, copy=False)


def device_words(arr, device) -> torch.Tensor:
    """Host ``uint32`` words -> a tensor in ``device``'s carrier:
    ``int32`` bit patterns on the card, ``int64`` on the CPU."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.from_numpy(arr.view(np.int32).copy()).to(device)
    return torch.from_numpy(arr.astype(np.int64))


def _host(arr) -> np.ndarray:
    """A numpy view of ``arr``; a torch tensor is copied to the host
    (floats as they are, words as ``uint32``)."""
    if isinstance(arr, torch.Tensor):
        if arr.is_floating_point():
            return arr.detach().cpu().numpy()
        return host_u32(arr)
    return arr


def encode_array(arr) -> tuple[int, bytes]:
    """1-D array or tensor -> ``(wire dtype code, little-endian
    bytes)``."""
    arr = np.ascontiguousarray(_host(arr))
    code = wire_code_for(arr.dtype)
    return code, arr.astype(_NP_DTYPES[code], copy=False).tobytes()


def decode_array(dtype_code: int, payload: bytes) -> np.ndarray:
    """Little-endian payload bytes -> native-order 1-D array."""
    dt = np_dtype_for(dtype_code)
    if len(payload) % dt.itemsize != 0:
        raise ProtocolError(
            f"payload of {len(payload)} bytes is not a multiple of "
            f"{dt.itemsize}")
    return np.frombuffer(payload, dtype=dt).astype(
        dt.newbyteorder("="), copy=False)


def encode_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def decode_json(payload: bytes):
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed JSON control payload: {e}") from e


def iter_chunks(arr: np.ndarray, chunk_elems: int):
    """Yield ``(offset, chunk)`` element-slices of a 1-D array.

    Zero-element logical messages do not exist on this wire (every
    counted leg carries ``b`` or ``s`` elements and the message meter
    rejects ``total_elems == 0``), so an empty array yields nothing —
    senders guard against empty payloads before chunking.
    """
    if chunk_elems <= 0:
        raise ValueError(f"chunk_elems={chunk_elems} must be positive")
    n = int(arr.shape[0])
    for off in range(0, n, chunk_elems):
        yield off, arr[off:off + chunk_elems]


def chunk_frames(msg_type: int, arr: np.ndarray, *, round_index: int,
                 phase: int, scheme: int, dtype_code: int, src: int,
                 dst: int, chunk_elems: int, chunk_base: int = 0,
                 total_elems: int | None = None):
    """Frame a logical message: one chunked ``Frame`` per slice.

    The single implementation of the chunk-send protocol (chunk_off /
    total_elems sequencing) — coordinator and party workers both frame
    through here, so their streams cannot drift apart.

    ``chunk_base``/``total_elems``: senders that stream a logical
    message incrementally (e.g. per-element-chunk VSS commitment
    blocks) pass the block's element offset inside the whole message
    and the whole-message length; the default frames ``arr`` as the
    complete message.
    """
    from .wire import Frame
    arr = _host(arr)
    total = int(arr.shape[0]) if total_elems is None else int(total_elems)
    for off, chunk in iter_chunks(arr, chunk_elems):
        _, payload = encode_array(chunk)
        yield Frame(msg_type, round=round_index, phase=phase,
                    scheme=scheme, dtype=dtype_code, src=src, dst=dst,
                    chunk_off=chunk_base + off, total_elems=total,
                    payload=payload)


# ---------------------------------------------------------------------------
# Pytree codec: nested dict/list/tuple of arrays <-> bytes
# ---------------------------------------------------------------------------

def _spec(tree, leaves: list) -> dict:
    if isinstance(tree, dict):
        # sort keys so the wire form is canonical regardless of dict
        # insertion order; decode restores the sorted order (dict
        # equality in Python is order-insensitive)
        return {"t": "dict",
                "k": sorted(tree),
                "v": [_spec(tree[k], leaves) for k in sorted(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_spec(x, leaves) for x in tree]}
    arr = np.asarray(_host(tree))
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    code = wire_code_for(arr.dtype)
    leaves.append(arr)
    return {"t": "leaf", "shape": list(arr.shape), "dtype": code}


def encode_pytree(tree) -> bytes:
    """Nested dict/list/tuple of uint32/float32 arrays -> bytes."""
    leaves: list[np.ndarray] = []
    spec = _spec(tree, leaves)
    body = b"".join(encode_array(np.ravel(a))[1] for a in leaves)
    head = encode_json(spec)
    return len(head).to_bytes(4, "big") + head + body


def decode_pytree(payload: bytes):
    if len(payload) < 4:
        raise ProtocolError("pytree payload shorter than its header size")
    head_len = int.from_bytes(payload[:4], "big")
    if 4 + head_len > len(payload):
        raise ProtocolError("pytree structure header overruns the payload")
    spec = decode_json(payload[4:4 + head_len])
    body = payload[4 + head_len:]
    offset = 0

    def build(node):
        nonlocal offset
        t = node.get("t")
        if t == "dict":
            return {k: build(v) for k, v in zip(node["k"], node["v"])}
        if t in ("list", "tuple"):
            seq = [build(v) for v in node["v"]]
            return seq if t == "list" else tuple(seq)
        if t == "leaf":
            dt = np_dtype_for(node["dtype"])
            size = int(np.prod(node["shape"])) if node["shape"] else 1
            nbytes = size * dt.itemsize
            if offset + nbytes > len(body):
                raise ProtocolError("pytree leaf overruns the payload")
            arr = decode_array(node["dtype"],
                               body[offset:offset + nbytes])
            offset += nbytes
            return arr.reshape(node["shape"])
        raise ProtocolError(f"unknown pytree node type {t!r}")

    tree = build(spec)
    if offset != len(body):
        raise ProtocolError(
            f"pytree payload has {len(body) - offset} trailing bytes")
    return tree
