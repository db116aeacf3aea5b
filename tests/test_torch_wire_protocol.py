"""The port's wire layer against the JAX package's, in one process.

No sockets and no subprocesses (those are ``tests/test_torch_wire.py``):

* the port's frames encode to the golden bytes the reference pins, and
  each package's ``decode_frame`` reads the other's frames;
* malformed input raises the same typed ``WireError`` subclass;
* ``WireConfig.to_json()`` equals the reference's for the same kwargs,
  and a WELCOME body of either package loads in the other;
* the codecs round-trip numpy arrays and torch tensors (``int64`` and
  ``int32`` word carriers) bit for bit;
* the assembler's and meter's conformance errors, ``StageMonitor`` on a
  ``ManualClock``, ``PartyRegistry`` leases, and a ``RegionIngest``
  digest folded by ``Network.absorb`` into the counters the reference's
  ingest gives;
* the wire's closed forms (``costmodel.message_*``,
  ``coordinator_*``) and ``faults.resolve_region_blames`` equal the
  reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costmodel as j_costmodel
from repro.fl import faults as j_faults
from repro.fl.transport import Network as JNetwork
from repro.net import config as j_config
from repro.net import region as j_region
from repro.net import wire as j_wire
from repro_torch.core import costmodel
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.fl import faults
from repro_torch.fl.transport import Network
from repro_torch.net import (BadMagicError, Frame, FrameReader, ManualClock,
                             MessageAssembler, MessageMeter, MsgType,
                             OversizedFrameError, PartyRegistry, Phase,
                             ProtocolError, RegionIngest, Scheme,
                             StageMonitor, StaleSessionError,
                             TruncatedFrameError, VersionError, WireConfig,
                             WireTimeoutError, Wiredtype, codec, wire)

pytestmark = pytest.mark.net

GOLDEN_FRAME = Frame(
    msg_type=MsgType.SHARE_UPLOAD, round=7, phase=Phase.PHASE2_UPLOAD,
    scheme=Scheme.ADDITIVE, dtype=Wiredtype.UINT32, src=2, dst=5,
    session=0x100003, chunk_off=128, total_elems=256,
    payload=np.array([1, 2, 3, 4], dtype="<u4").tobytes())

#: the reference's pinned version-2 layout (tests/test_wire_protocol.py)
GOLDEN_BYTES = bytes.fromhex(
    "00000030" "3250" "02" "09" "00000007" "02" "01" "01" "00"
    "00000002" "00000005" "00100003" "00000080" "00000100"
    "01000000" "02000000" "03000000" "04000000")


def _frames():
    """One frame of each kind the protocol sends, in both packages."""
    return [
        GOLDEN_FRAME,
        Frame(MsgType.HELLO, src=3,
              payload=codec.encode_json({"addr": ["127.0.0.1", 4242]})),
        Frame(MsgType.COMMIT, round=3, dst=1, session=0x200002,
              payload=codec.encode_json({"included": [0, 2], "l": 2})),
        Frame(MsgType.BROADCAST, round=1, phase=Phase.PHASE2_BROADCAST,
              scheme=Scheme.SHAMIR, dtype=Wiredtype.FLOAT32, src=0, dst=3,
              chunk_off=0, total_elems=2,
              payload=np.array([1.5, -np.inf], dtype="<f4").tobytes()),
        Frame(MsgType.RESULT, round=0xFFFFFFFF, phase=Phase.WIRE_RESULT,
              dtype=Wiredtype.FLOAT32, src=2, dst=-1, total_elems=1,
              payload=np.array([np.nan], dtype="<f4").tobytes()),
    ]


def _as_reference(frame: Frame) -> j_wire.Frame:
    return j_wire.Frame(**dataclasses.asdict(frame))


def test_golden_frame_encodes_to_the_references_pinned_bytes():
    assert wire.encode_frame(GOLDEN_FRAME) == GOLDEN_BYTES
    frame, used = wire.decode_frame(GOLDEN_BYTES)
    assert used == len(GOLDEN_BYTES) and frame == GOLDEN_FRAME
    assert (wire.PROTOCOL_VERSION, wire.HEADER_SIZE) == (2, 32)


@pytest.mark.parametrize("k", range(5))
def test_each_package_decodes_the_others_frames(k):
    frame = _frames()[k]
    mine = wire.encode_frame(frame)
    theirs = j_wire.encode_frame(_as_reference(frame))
    assert mine == theirs
    got, _ = j_wire.decode_frame(mine)
    assert dataclasses.asdict(got) == dataclasses.asdict(frame)
    got, _ = wire.decode_frame(theirs)
    assert got == frame


def test_codes_equal_the_references():
    for ours, ref in ((MsgType, j_wire.MsgType), (Phase, j_wire.Phase),
                      (Scheme, j_wire.Scheme),
                      (Wiredtype, j_wire.Wiredtype)):
        assert {k: v for k, v in vars(ours).items() if k.isupper()} == \
            {k: v for k, v in vars(ref).items() if k.isupper()}


@pytest.mark.parametrize("case", ["truncated", "bad_magic", "version",
                                  "oversized", "dtype", "overrun"])
def test_malformed_input_raises_the_references_typed_error(case):
    good = bytearray(GOLDEN_BYTES)
    if case == "truncated":
        data, err = bytes(good[:-1]), TruncatedFrameError
    elif case == "bad_magic":
        good[4:6] = b"XX"
        data, err = bytes(good), BadMagicError
    elif case == "version":
        good[6] = 9
        data, err = bytes(good), VersionError
    elif case == "oversized":
        data = (wire.HEADER_SIZE + wire.MAX_PAYLOAD_BYTES + 1).to_bytes(
            4, "big") + bytes(good[4:])
        err = OversizedFrameError
    elif case == "dtype":
        bad = Frame(MsgType.SHARE_UPLOAD, phase=Phase.PHASE2_UPLOAD,
                    dtype=Wiredtype.UINT32, total_elems=4, payload=b"abc")
        data, err = wire.encode_frame(bad), ProtocolError
    else:
        bad = dataclasses.replace(GOLDEN_FRAME, chunk_off=254)
        data, err = wire.encode_frame(bad), ProtocolError
    with pytest.raises(err):
        wire.decode_frame(data)
    ref_err = getattr(j_wire, err.__name__)
    with pytest.raises(ref_err):
        j_wire.decode_frame(data)


def test_frame_reader_buffers_partial_frames_and_types_eof():
    reader = FrameReader()
    data = wire.encode_frame(GOLDEN_FRAME) * 2
    assert reader.feed(data[:10]) == []
    got = reader.feed(data[10:-3])
    assert got == [GOLDEN_FRAME]
    with pytest.raises(TruncatedFrameError):
        reader.eof()
    assert reader.feed(data[-3:]) == [GOLDEN_FRAME]
    reader.eof()


@pytest.mark.parametrize("kw", [
    dict(n=4),
    dict(n=8, m=3, scheme="shamir", shamir_degree=1, vss=True,
         norm_bound=8.0, relay="tree", warmup=True, seed=5),
    dict(n=50, m=4, cohort=9, pipeline=True, lease_s=None,
         chunk_elems=1 << 16, deadline_s=None, reelect_each_round=True),
])
def test_wire_config_json_equals_the_references(kw):
    ours = WireConfig.from_aggregation_kwargs(**kw)
    ref = j_config.WireConfig.from_aggregation_kwargs(**kw)
    assert ours.to_json() == ref.to_json()
    # a WELCOME body of either package loads in the other
    assert WireConfig.from_json(ref.to_json()) == ours
    assert j_config.WireConfig.from_json(ours.to_json()) == ref
    with pytest.raises(ProtocolError, match="unknown fields"):
        WireConfig.from_json({**ours.to_json(), "device": "cuda"})
    agg = ours.aggregator("cpu")
    assert agg.device.type == "cpu" and agg.fp == ours.fp()


@pytest.mark.parametrize("carrier", ["numpy", "int64", "int32"])
def test_word_codecs_round_trip_every_carrier(carrier):
    words = np.random.RandomState(3).randint(
        0, 2 ** 32, size=1001, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    arr = {"numpy": words,
           "int64": torch.from_numpy(words.astype(np.int64)),
           "int32": torch.from_numpy(words.view(np.int32).copy())}[carrier]
    code, payload = codec.encode_array(arr)
    assert code == Wiredtype.UINT32
    assert payload == words.astype("<u4").tobytes()
    back = codec.decode_array(code, payload)
    assert np.array_equal(back, words)
    # device_words -> host_u32 is the identity on the CPU carrier
    t = codec.device_words(back, "cpu")
    assert t.dtype == torch.int64
    assert np.array_equal(codec.host_u32(t), words)


def test_float32_and_pytree_codecs_keep_exact_bits():
    x = np.array([np.nan, -0.0, 1e-45, np.inf, 3.25], dtype=np.float32)
    x.view(np.uint32)[0] = 0x7FC01234          # a NaN payload survives
    code, payload = codec.encode_array(torch.from_numpy(x.copy()))
    back = codec.decode_array(code, payload)
    assert np.array_equal(back.view(np.uint32), x.view(np.uint32))
    tree = {"b": [torch.arange(6, dtype=torch.float32).reshape(2, 3)],
            "a": (np.arange(4, dtype=np.uint32),)}
    got = codec.decode_pytree(codec.encode_pytree(tree))
    assert np.array_equal(got["b"][0], np.arange(6, dtype=np.float32)
                          .reshape(2, 3))
    assert isinstance(got["a"], tuple)
    assert np.array_equal(got["a"][0], np.arange(4, dtype=np.uint32))
    with pytest.raises(ProtocolError, match="trailing"):
        codec.decode_pytree(codec.encode_pytree(tree) + b"\0\0\0\0")


def _chunks(arr, chunk, **kw):
    base = dict(round_index=2, phase=Phase.PHASE2_UPLOAD,
                scheme=Scheme.ADDITIVE, dtype_code=Wiredtype.UINT32, src=1,
                dst=0, chunk_elems=chunk)
    base.update(kw)
    return list(codec.chunk_frames(MsgType.SHARE_UPLOAD, arr, **base))


def test_assembler_and_meter_reassemble_and_count():
    arr = np.arange(1000, dtype=np.uint32)
    frames = _chunks(arr, 128)
    assert len(frames) == costmodel.message_frames(1000, 128) == 8
    assert sum(len(wire.encode_frame(f)) for f in frames) == \
        costmodel.message_wire_bytes(1000, 128)
    asm = MessageAssembler(round_index=2)
    net = Network()
    meter = MessageMeter(net, round_index=2)
    outs = [asm.feed(f) for f in frames]
    done = [meter.feed(f) for f in frames]
    assert all(o is None for o in outs[:-1]) and done == [False] * 7 + [True]
    assert np.array_equal(outs[-1], arr)
    assert (net.stats("phase2_upload").msg_num,
            net.stats("phase2_upload").msg_size) == (1, 1000)


@pytest.mark.parametrize("case", ["round", "order", "meta", "bound",
                                  "zero", "phase"])
def test_assembler_and_meter_raise_typed_conformance_errors(case):
    arr = np.arange(300, dtype=np.uint32)
    frames = _chunks(arr, 128)
    if case == "round":
        feed = [dataclasses.replace(frames[0], round=3)]
    elif case == "order":
        feed = [frames[1]]
    elif case == "meta":
        feed = [frames[0], dataclasses.replace(frames[1], total_elems=301)]
    elif case == "bound":
        feed = frames
    elif case == "zero":
        feed = [dataclasses.replace(frames[0], total_elems=0, payload=b"")]
    else:
        feed = [dataclasses.replace(frames[0], phase=Phase.CONTROL)]
    for make in (lambda: MessageAssembler(round_index=2, max_elems=299),
                 lambda: MessageMeter(Network(), round_index=2,
                                      max_elems=299)):
        sink = make()
        if case != "bound":
            sink.max_elems = None
        with pytest.raises(ProtocolError):
            for f in feed:
                sink.feed(f)


def test_stage_monitor_on_a_manual_clock():
    clock = ManualClock()
    mon = StageMonitor({0, 1, 2, 3}, deadline_s=2.0, clock=clock).start()
    mon.completed(0)
    mon.eof(1)
    mon.eof(0)                     # a completed party's EOF is no dropout
    clock.advance(1.5)
    mon.check()
    assert mon.pending() == {2, 3} and not mon.expired()
    mon.completed(2)
    clock.advance(0.6)
    mon.check()
    assert mon.settled()
    assert (mon.dropped, mon.straggled) == ({1}, {3})
    with pytest.raises(ValueError):
        clock.advance(-1)
    nobody = StageMonitor({5}, deadline_s=None, clock=clock).start()
    nobody.eof(5)
    with pytest.raises(WireTimeoutError):
        nobody.require_any_progress()


def test_party_registry_leases_sessions_and_expiry():
    reg = PartyRegistry(4, lease_s=10.0)
    s0 = reg.register(2, now=0.0)
    assert s0 == 3 and reg.session_of(2) == s0
    assert reg.resume(2, s0, now=5.0) == s0
    s1 = reg.register(2, now=6.0)                  # re-HELLO supersedes
    assert s1 == (1 << 20) | 3
    with pytest.raises(StaleSessionError, match="stale"):
        reg.validate(2, s0, now=6.0)
    with pytest.raises(StaleSessionError, match="expired"):
        reg.resume(2, s1, now=17.0)
    reg.validate(2, s1, now=17.0, enforce_expiry=False)
    reg.register(0, now=10.0)
    assert reg.eligible(now=17.0) == {0}
    assert reg.expire(now=17.0) == {2} and len(reg) == 1
    with pytest.raises(StaleSessionError, match="no registration"):
        reg.resume(3, 4, now=0.0)
    with pytest.raises(ValueError):
        reg.register(4)


def test_region_digest_folds_through_absorb_as_the_reference():
    """A home member's ingest of two parties' uploads (m = 2 rows each,
    chunked) reports the digest the reference's ingest reports, and
    ``Network.absorb`` folds it into the counters the hub meter would
    have counted."""
    roster = {0: 11, 3: 12}
    ours = RegionIngest(round_index=1, roster=roster, expect_msgs=2)
    ref = j_region.RegionIngest(round_index=1, roster=roster,
                                expect_msgs=2)
    done = []
    rng = np.random.RandomState(4)
    for src in (0, 3):
        for dst in (5, 6):
            rows = rng.randint(0, 2 ** 31, size=200).astype(np.uint32)
            for f in _chunks(rows, 128, round_index=1, src=src, dst=dst):
                done.append(ours.feed(f, roster[src]))
                ref.feed(j_wire.Frame(**dataclasses.asdict(f)), roster[src])
    assert [d for d in done if d is not None] == [0, 3]
    assert ours.complete([0, 3]) and ours.digest() == ref.digest()
    assert np.array_equal(ours.rows[(3, 6)], ref.rows[(3, 6)])
    with pytest.raises(StaleSessionError):
        ours.feed(_chunks(np.zeros(4, np.uint32), 128, round_index=1,
                          src=0)[0], 99)
    net, jnet = Network(), JNetwork()
    for phase, (num, size) in ours.digest().items():
        net.absorb(num, size, phase)
        jnet.absorb(num, size, phase)
    assert dataclasses.asdict(net.stats("phase2_upload")) == \
        dataclasses.asdict(jnet.stats("phase2_upload")) == \
        {"msg_num": 4, "msg_size": 800}
    with pytest.raises(ValueError, match="inconsistent"):
        net.absorb(1, 0, "phase2_upload")


@pytest.mark.parametrize("kw", [
    dict(relay="hub"), dict(relay="tree"),
    dict(relay="hub", vss=True, degree=1, audit=True),
    dict(relay="tree", vss=True, degree=2, audit=True,
         region_sizes=[2, 3, 3]),
    dict(relay="tree", vss=True, c=6, subrounds=2),
])
def test_coordinator_byte_forms_equal_the_references(kw):
    p = costmodel.CostParams(n=8, e=1, s=2_500_000, m=3, b=10)
    jp = j_costmodel.CostParams(n=8, e=1, s=2_500_000, m=3, b=10)
    c = kw.pop("c", None)
    assert costmodel.coordinator_round_legs(p, c=c, **kw) == \
        j_costmodel.coordinator_round_legs(jp, c=c, **kw)
    assert costmodel.coordinator_data_bytes(
        p, c=c, chunk_elems=1 << 20, **kw) == \
        j_costmodel.coordinator_data_bytes(jp, c=c, chunk_elems=1 << 20,
                                           **kw)


@pytest.mark.parametrize("accusations,live", [
    ({1: {0, 2}}, [0, 1, 2]), ({1: {0}}, [0, 1, 2]),
    ({1: {1, 0}}, [0, 1, 2]), ({0: {1, 2, 3}, 3: {0}}, [0, 1, 2, 3]),
    ({2: {0, 1, 3}}, [0, 1, 2]),
])
def test_region_blame_quorum_equals_the_references(accusations, live):
    assert faults.resolve_region_blames(accusations, live) == \
        j_faults.resolve_region_blames(accusations, live)
    assert faults.TAMPER_SEED_XOR == j_faults.TAMPER_SEED_XOR


def test_wire_config_rejects_what_the_reference_rejects():
    for kw, match in ((dict(vss=True), "shamir"),
                      (dict(pipeline=True), "cohort"),
                      (dict(relay="ring"), "relay"),
                      (dict(chunk_elems=100), "multiple")):
        with pytest.raises(ValueError, match=match):
            WireConfig(n=4, **kw)
    fp = FixedPointConfig(frac_bits=10, clip=64.0, algebra="field")
    cfg = WireConfig.from_aggregation_kwargs(4, scheme="shamir", fp=fp)
    assert (cfg.frac_bits, cfg.algebra, cfg.degree(),
            cfg.reconstruct_threshold(), cfg.commit_elems(5)) == \
        (10, "field", 2, 3, 30)
