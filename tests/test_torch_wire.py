"""The port's wire transport over real processes and sockets (-m net).

Each test spawns party worker processes (``python -m
repro_torch.net.party --device cpu``) and runs the two-phase protocol
over localhost TCP.  No test has a wall-clock bound, and the workers run
with ``deadline_s=None``:

* additive rounds under the hub and the tree relay, two rounds each:
  means bit-identical to the port's sim and to the reference's sim,
  counters equal to Eqs. 3-6 and to the sim's phase by phase, the
  coordinator's bytes equal to ``costmodel.coordinator_data_bytes``;
* a Shamir round at degree 1;
* a member killed right after its upload (``--die-after-upload``): the
  sub-threshold mean and the ``RoundOutcome`` the reference's fault
  module resolves for that pattern;
* a VSS member tampering with ``flip``: blamed, evicted, re-elected away,
  the mean the honest one;
* a mixed round: the reference's coordinator with two of the port's
  workers and two of the reference's, bit-identical to both sims;
* without workers, raw-socket parties against the port's coordinator:
  registration, duplicate rejection, re-registration, the typed stale
  session error and a resume, then a stop that returns (the coordinator
  closes every connection it accepted, superseded ones too).
"""

import asyncio

import functools
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.fl import faults as j_faults
from repro.fl import make_transport as j_make_transport
from repro.net import WireTransport as JWireTransport
from repro_torch.core import committee, costmodel
from repro_torch.core.costmodel import CostParams
from repro_torch.fl import make_transport
from repro_torch.fl.faults import RoundOutcome

pytestmark = pytest.mark.net

SRC = Path(__file__).resolve().parents[1] / "src"
N, S, M, B, SEED = 4, 242, 3, 10, 1
ROUNDS = 2
PHASES = ("phase1", "phase2_upload", "phase2_exchange", "phase2_broadcast")


def _flats():
    return np.random.RandomState(0).randn(N, S).astype(np.float32)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).view(torch.int32)


@functools.lru_cache(maxsize=None)
def _reference_sim_means(scheme: str, degree, rounds: int):
    """The reference's sim means (its eager JAX, computed once)."""
    sim = j_make_transport("two_phase", N, m=M, seed=SEED, scheme=scheme,
                           shamir_degree=degree)
    sim.elect()
    return tuple(np.asarray(sim.aggregate(_flats(), round_index=r))
                 for r in range(rounds))


def _port_sim(scheme="additive", degree=None, **kw):
    sim = make_transport("two_phase", N, m=M, seed=SEED, scheme=scheme,
                         shamir_degree=degree, device="cpu", **kw)
    sim.elect()
    return sim


def _wire(log_dir, **kw):
    return make_transport("two_phase", N, backend="wire", m=M, seed=SEED,
                          device="cpu", deadline_s=None, log_dir=log_dir,
                          **kw)


@pytest.mark.parametrize("relay", ["hub", "tree"])
def test_wire_rounds_match_both_sims_and_the_closed_forms(relay,
                                                          net_log_dir):
    flats = torch.from_numpy(_flats())
    sim = _port_sim()
    sim_means = [sim.aggregate(flats, round_index=r) for r in range(ROUNDS)]
    ref_means = _reference_sim_means("additive", None, ROUNDS)
    with _wire(net_log_dir, relay=relay) as wire:
        assert wire.elect() == sim.committee
        for r in range(ROUNDS):
            got = wire.aggregate(flats, round_index=r)
            assert got.device.type == "cpu" and got.dtype == torch.float32
            assert torch.equal(_bits(got), _bits(sim_means[r]))
            assert torch.equal(_bits(got), _bits(ref_means[r]))
            assert wire.last_outcome == RoundOutcome(
                alive=set(range(N)), dropped=set(), straggled=set())
            if r == 0:
                # one honest round's coordinator bytes, exactly
                p = CostParams(n=N, s=S, m=M, b=B)
                assert (wire.coordinator.data_bytes_in,
                        wire.coordinator.data_bytes_out) == \
                    costmodel.coordinator_data_bytes(
                        p, relay=relay, chunk_elems=wire.cfg.chunk_elems)
        p = CostParams(n=N, e=ROUNDS, s=S, m=M, b=B)
        st1 = wire.net.stats("phase1")
        assert (st1.msg_num, st1.msg_size) == (
            costmodel.phase1_msg_num(p), costmodel.phase1_msg_size(p))
        p2 = [wire.net.stats(ph) for ph in PHASES[1:]]
        assert (sum(x.msg_num for x in p2), sum(x.msg_size for x in p2)) \
            == (costmodel.phase2_msg_num(p), costmodel.phase2_msg_size(p))
        for ph in PHASES:
            assert wire.net.stats(ph) == sim.net.stats(ph), ph


def test_wire_shamir_round_at_degree_1(net_log_dir):
    flats = torch.from_numpy(_flats())
    want = _port_sim("shamir", 1).aggregate(flats, round_index=0)
    ref = _reference_sim_means("shamir", 1, 1)[0]
    with _wire(net_log_dir, scheme="shamir", shamir_degree=1) as wire:
        got = wire.aggregate(flats, round_index=0)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got), _bits(ref))


def test_member_killed_after_upload_gives_the_references_outcome(
        net_log_dir):
    """A member exits right after its uploads: the coordinator sees EOF,
    the round reconstructs sub-threshold (Shamir, degree 1), the mean is
    the sim's with that member dropped, and the outcome is the one the
    reference's fault module resolves for the pattern."""
    flats = torch.from_numpy(_flats())
    com = committee.elect(N, M, B, SEED, device="cpu").committee
    victim = com[1]
    want = _port_sim("shamir", 1).aggregate(flats, round_index=0,
                                            committee_dropout=[victim])
    with _wire(net_log_dir, scheme="shamir", shamir_degree=1,
               party_extra_args={victim: ["--die-after-upload", "0"]}
               ) as wire:
        wire.elect()
        got = wire.aggregate(flats, round_index=0)
        assert torch.equal(_bits(got), _bits(want))
        ref = j_faults.resolve_outcome(
            set(range(N)), dropped={victim}, straggled=set(),
            committee=com, reconstruct_threshold=2, resurrect=False)
        out = wire.last_outcome
        assert (out.alive, out.dropped, out.straggled, out.blamed) == \
            (ref.alive, ref.dropped, ref.straggled, ref.blamed)
        assert out.dropped == {victim}
        assert wire.net.stats("phase2_exchange").msg_num == M - 2
        assert wire.net.stats("phase2_upload").msg_num == N * M


def test_vss_flip_tamperer_is_blamed_evicted_and_reelected_away(
        net_log_dir):
    flats = torch.from_numpy(_flats())
    victim = committee.elect(N, M, B, SEED, device="cpu").committee[0]
    honest = _port_sim("shamir", 1, vss=True, reelect_each_round=True)
    honest_means = [honest.aggregate(flats, round_index=r)
                    for r in range(2)]
    sim = _port_sim("shamir", 1, vss=True, reelect_each_round=True)
    sim.aggregate(flats, round_index=0, committee_tamper={victim: "flip"})
    sim_outcome = sim.last_outcome
    sim.aggregate(flats, round_index=1)
    with _wire(net_log_dir, scheme="shamir", shamir_degree=1, vss=True,
               warmup=True, reelect_each_round=True,
               party_extra_args={victim: ["--tamper", "flip",
                                          "--tamper-round", "0"]}) as wire:
        got = wire.aggregate(flats, round_index=0)
        assert torch.equal(_bits(got), _bits(honest_means[0]))
        assert wire.last_outcome == sim_outcome
        assert wire.last_outcome.blamed == {victim}
        assert wire.evicted == {victim}
        got = wire.aggregate(flats, round_index=1)
        assert torch.equal(_bits(got), _bits(honest_means[1]))
        assert victim not in wire.committee
        assert wire.committee == sim.committee
        p = CostParams(n=N, e=2, s=S, m=M, b=B)
        st = wire.net.stats("phase2_commit")
        assert (st.msg_num, st.msg_size) == (
            costmodel.phase2_commit_msg_num(p),
            costmodel.phase2_commit_msg_size(p, 1))


def test_mixed_round_reference_coordinator_with_both_workers(net_log_dir):
    """The reference's coordinator (its transport started without
    spawning) with parties 0 and 2 run by the port's worker on the CPU
    and parties 1 and 3 by the reference's worker: one additive round,
    bit-identical to both sims."""
    flats = _flats()
    want = _port_sim().aggregate(torch.from_numpy(flats), round_index=0)
    ref = _reference_sim_means("additive", None, 1)[0]
    tr = JWireTransport(N, m=M, seed=SEED, spawn=False, start=False,
                        deadline_s=None, log_dir=net_log_dir)
    started = threading.Thread(target=tr.start, daemon=True)
    started.start()
    while tr.port is None and started.is_alive():
        time.sleep(0.05)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for pid in range(N):
            module = ("repro_torch.net.party" if pid % 2 == 0
                      else "repro.net.party")
            cmd = [sys.executable, "-m", module, "--port", str(tr.port),
                   "--party-id", str(pid), "--log-file",
                   os.path.join(net_log_dir, f"mixed-{pid}.log")]
            if pid % 2 == 0:
                cmd += ["--device", "cpu"]
            procs.append(subprocess.Popen(
                cmd, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        started.join(timeout=300)
        assert not started.is_alive() and tr.coordinator is not None
        tr.elect()
        got = tr.aggregate(flats, round_index=0)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(got), _bits(ref))
        assert set(tr.last_outcome.alive) == set(range(N))
    finally:
        tr.close()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    torch_log = Path(net_log_dir, "mixed-0.log").read_text()
    assert '"device": "cpu"' in torch_log and '"round": 0' in torch_log


def test_coordinator_sessions_and_stop_close_every_connection():
    """The reference's register/resume protocol (``tests/test_session.py``)
    against the port's coordinator, over raw sockets; ``stop()`` must
    return although party 0 re-registered twice."""
    from repro_torch.net import codec
    from repro_torch.net.config import WireConfig
    from repro_torch.net.coordinator import Coordinator
    from repro_torch.net.wire import Frame, FrameReader, MsgType, encode_frame

    co = Coordinator(WireConfig(n=2, m=2, lease_s=30.0, deadline_s=None))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(30.0)

    def hello(pid, session=0):
        sock = socket.create_connection(("127.0.0.1", port), timeout=10.0)
        sock.sendall(encode_frame(Frame(MsgType.HELLO, src=pid,
                                        session=session)))
        return sock, recv(sock)

    def recv(sock):
        reader = FrameReader()
        while True:
            data = sock.recv(65536)
            if not data:
                return None
            frames = reader.feed(data)
            if frames:
                return frames[0]

    def wait_dead(pid):
        t0 = time.monotonic()
        while co._conns[pid].alive:
            assert time.monotonic() - t0 < 10.0, f"party {pid} never died"
            time.sleep(0.01)

    port = run(co.start("127.0.0.1", 0))
    try:
        p1, w = hello(0)
        assert w.msg_type == MsgType.WELCOME and w.session == 0x1
        assert codec.decode_json(w.payload)["n"] == 2
        dup, got = hello(0)                  # the first socket is alive
        assert got is None and co.registry.session_of(0) == 0x1
        dup.close()
        p1.close()
        wait_dead(0)
        p2, w = hello(0)                     # fresh: the generation bumps
        assert w.session == (1 << 20) | 1
        p2.close()
        wait_dead(0)
        p3, err = hello(0, session=0x1)      # the superseded session
        assert err.msg_type == MsgType.ERROR
        assert "stale" in codec.decode_json(err.payload)["error"]
        assert recv(p3) is None
        p3.close()
        p4, w = hello(0, session=(1 << 20) | 1)
        assert w.session == (1 << 20) | 1    # resumed, same id
        p4.close()
    finally:
        run(co.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)
        loop.close()
