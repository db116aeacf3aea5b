"""``WireTransport`` — the multi-process transport behind the ABC.

Counterpart of ``repro/net/transport.py``.  Same ``Transport`` interface
as the counting simulation transports (``elect()`` /
``aggregate(flats, party_ids, round_index=...)``), so ``FLSimulation``
and ``run_fedavg`` drive a *real* multi-process two-phase deployment
unchanged.  Construction starts an asyncio coordinator on a background
thread (on the host) and, by default, spawns one
``repro_torch.net.party`` worker process per party with ``--device``
set to the transport's device (the card unless ``device="cpu"``);
``aggregate`` blocks the caller while the round runs over actual TCP
sockets and returns the mean as a tensor on that device.

Wire accounting lands in the same ``Network`` counters the simulation
uses (phases ``phase1`` / ``phase2_upload`` / ``phase2_exchange`` /
``phase2_broadcast`` + the uncounted hub phases ``wire_input`` /
``wire_result``), so one set of assertions cross-checks Eqs. 1–8
against *measured* traffic on both backends.

Use as a context manager (or call ``close()``): worker processes and
the server thread are real OS resources.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.fl.transport import Network, Transport
from repro_torch.kernels import dispatch

from .config import WireConfig
from .coordinator import Coordinator
from .wire import WireError

__all__ = ["WireTransport"]


def _src_root() -> str:
    """Directory to put on a worker's PYTHONPATH (parent of
    repro_torch/)."""
    import repro_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))


class WireTransport(Transport):
    """Two-phase MPC over real sockets and separate party processes.

    ``device``: where the spawned workers do the party math and where
    ``aggregate`` returns the mean; it is not part of ``WireConfig``
    (each worker picks its own), so workers of either package can join.
    """

    protocol = "two_phase"

    def __init__(self, n: int, *, m: int = 3, scheme: str = "additive",
                 seed: int = 0, b: int = 10, net: Network | None = None,
                 fp=None, shamir_degree: int | None = None,
                 chunk_elems: int | None = None,
                 deadline_s: float | None = 30.0,
                 vss: bool = False, reelect_each_round: bool = False,
                 norm_bound: float | None = None,
                 cohort: int | None = None, pipeline: bool = False,
                 lease_s: float | None = 30.0, relay: str = "hub",
                 warmup: bool = False,
                 dealer_tamper: dict | None = None,
                 round_timeout_s: float = 120.0,
                 host: str = "127.0.0.1", port: int = 0,
                 spawn: bool = True,
                 party_extra_args: dict[int, list[str]] | None = None,
                 log_dir: str | None = None, start: bool = True,
                 startup_timeout_s: float = 60.0, device="cuda"):
        self.device = dispatch.resolve_device(device)
        self.cfg = WireConfig.from_aggregation_kwargs(
            n, m=m, b=b, seed=seed, scheme=scheme, fp=fp,
            shamir_degree=shamir_degree, chunk_elems=chunk_elems,
            deadline_s=deadline_s, vss=vss,
            reelect_each_round=reelect_each_round,
            norm_bound=norm_bound, cohort=cohort, pipeline=pipeline,
            lease_s=lease_s, relay=relay, warmup=warmup)
        # dealer_tamper {pid: (mode, round)} becomes per-party --poison
        # CLI flags: on the wire the adversary is the *worker process*
        # poisoning its own input, not a coordinator-side mutation
        party_extra_args = dict(party_extra_args or {})
        for pid, (mode, rnd) in (dealer_tamper or {}).items():
            pid = int(pid)
            if not 0 <= pid < n:
                raise ValueError(
                    f"dealer_tamper party {pid} outside range({n})")
            party_extra_args[pid] = (list(party_extra_args.get(pid, []))
                                     + ["--poison", str(mode),
                                        "--poison-round", str(int(rnd))])
        self.n = n
        self.m = m
        self.b = b
        self.seed = seed
        self.scheme = scheme
        self.shamir_degree = shamir_degree
        self.net = net if net is not None else Network()
        self.round_timeout_s = round_timeout_s
        self.host = host
        self._requested_port = port
        self.spawn = spawn
        self.party_extra_args = party_extra_args
        self.log_dir = log_dir or os.environ.get("REPRO_NET_LOG_DIR")
        self.startup_timeout_s = startup_timeout_s
        self.port: int | None = None
        self.committee: tuple[int, ...] | None = None
        #: per-round sampled cohort (None outside cohort mode) — the
        #: driver mirrors it against fl.cohort.sample_cohort
        self.cohort = cohort
        self.cohort_ids: tuple[int, ...] | None = None
        self.last_outcome = None
        self.coordinator: Coordinator | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._procs: list[subprocess.Popen] = []
        self._log_fh = None
        self._closed = False
        #: seconds from the coordinator's bind to every party registered
        #: (the workers' process and import start-up, when spawned)
        self.startup_s: float | None = None
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self._log_fh is not None:
            self._log_fh.write(f"[coordinator] {msg}\n")

    def start(self) -> "WireTransport":
        if self._loop is not None:
            return self
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_fh = open(os.path.join(self.log_dir,
                                             "coordinator.log"),
                                "a", buffering=1)
        self.coordinator = Coordinator(self.cfg, net=self.net,
                                       log=self._log)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever,
            name="repro-net-coordinator", daemon=True)
        self._thread.start()
        atexit.register(self.close)
        self.port = self._run(
            self.coordinator.start(self.host, self._requested_port),
            timeout=self.startup_timeout_s)
        t0 = time.perf_counter()
        if self.spawn:
            self._spawn_parties()
        self._run(self.coordinator.wait_for_parties(self.startup_timeout_s),
                  timeout=self.startup_timeout_s + 5)
        self.startup_s = time.perf_counter() - t0
        return self

    def _spawn_parties(self) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = (_src_root() + os.pathsep
                             + env.get("PYTHONPATH", ""))
        for pid in range(self.cfg.n):
            cmd = [sys.executable, "-m", "repro_torch.net.party",
                   "--host", self.host, "--port", str(self.port),
                   "--party-id", str(pid), "--device", str(self.device)]
            if self.log_dir:
                cmd += ["--log-file",
                        os.path.join(self.log_dir, f"party-{pid}.log")]
            cmd += self.party_extra_args.get(pid, [])
            out = subprocess.DEVNULL
            if self.log_dir:
                out = open(os.path.join(self.log_dir,
                                        f"party-{pid}.stderr"), "ab")
            self._procs.append(subprocess.Popen(
                cmd, env=env, stdout=out, stderr=out,
                stdin=subprocess.DEVNULL))
            if out is not subprocess.DEVNULL:
                out.close()

    def _run(self, coro, timeout: float | None = None):
        if self._loop is None:
            raise WireError("WireTransport is not started")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout if timeout is not None
                              else self.round_timeout_s)
        except TimeoutError:
            fut.cancel()
            raise

    @property
    def evicted(self) -> set:
        """Members the VSS layer blamed and evicted (coordinator view)."""
        return (set(self.coordinator.evicted)
                if self.coordinator is not None else set())

    # -- Transport interface ---------------------------------------------

    def elect(self, round_index: int = 0,
              eligible=None) -> tuple[int, ...]:
        self.committee = self._run(
            self.coordinator.elect(round_index, eligible=eligible))
        self.cohort_ids = self.coordinator.cohort_ids
        return self.committee

    def aggregate(self, flats, party_ids=None, *, round_index: int = 0,
                  eligible=None, pipeline_next_eligible=None):
        if isinstance(flats, (list, tuple)):
            flats = torch.stack([torch.as_tensor(f) for f in flats])
        if isinstance(flats, torch.Tensor):
            flats = flats.detach().to(torch.float32).cpu().numpy()
        flats = np.asarray(flats, dtype=np.float32)
        if flats.ndim == 1:
            flats = flats[None]
        ids = (list(range(flats.shape[0])) if party_ids is None
               else [int(i) for i in party_ids])
        if self.committee is None and self.cfg.cohort is None:
            self.elect(round_index)
        mean, outcome = self._run(
            self.coordinator.aggregate(
                round_index, flats, ids, eligible=eligible,
                pipeline_next_eligible=pipeline_next_eligible))
        self.committee = self.coordinator.committee
        self.cohort_ids = self.coordinator.cohort_ids
        self.last_outcome = outcome
        return torch.from_numpy(np.array(mean, dtype=np.float32)).to(
            self.device)

    # -- teardown ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        if self._loop is not None and self.coordinator is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self.coordinator.stop(), self._loop).result(10)
            except Exception:
                pass
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._loop.close()
            self._loop = None
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    def __enter__(self) -> "WireTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # last-resort resource cleanup
        try:
            self.close()
        except Exception:
            pass
