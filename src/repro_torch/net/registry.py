"""Lease-based party registration and session ids (DESIGN.md §12).

A copy of ``repro/net/registry.py``.

The coordinator no longer treats "connected socket" as the membership
truth: a party *registers* and holds a renewable **lease**.  Each
registration mints a session id that travels in every frame header
(``Frame.session``, next to ``src``/``dst``), so

* a reconnecting party can **resume** its lease mid-round — same
  session id, same logical identity, no protocol state lost;
* a frame from a superseded or expired lease is a typed
  :class:`~repro_torch.net.wire.StaleSessionError`, never silently folded
  into a round it no longer belongs to;
* the round driver samples each round's **cohort** from the set of
  live leases (``eligible()``), decoupling registry size (100k+) from
  per-round participation.

Session id layout: ``((generation & 0xFFF) << 20) | (pid + 1)`` —
non-zero by construction (0 on the wire means "no session yet", i.e. a
fresh HELLO), party-recoverable, and superseded whenever the same pid
re-registers (the generation bumps).  The registry is a pure state
machine over injected timestamps: no clock of its own, no sockets —
unit-testable without sleeping, like ``timeouts.StageMonitor``.
"""

from __future__ import annotations

import dataclasses

from .wire import StaleSessionError

__all__ = ["PartyLease", "PartyRegistry", "SESSION_PID_MASK"]

#: low 20 bits of a session id hold ``pid + 1`` (up to ~1M parties)
SESSION_PID_MASK = (1 << 20) - 1


def session_pid(session: int) -> int:
    """Party id encoded in a session id (-1 if malformed/zero)."""
    return (int(session) & SESSION_PID_MASK) - 1


@dataclasses.dataclass
class PartyLease:
    pid: int
    session: int
    generation: int
    expires_at: float


class PartyRegistry:
    """Registration leases for up to ``n`` parties.

    All methods take ``now`` (a monotonic timestamp from the caller's
    clock); ``lease_s=None`` disables expiry (leases live until
    superseded), matching ``deadline_s=None`` elsewhere in the net
    layer.
    """

    def __init__(self, n: int, *, lease_s: float | None = 30.0):
        if n < 1:
            raise ValueError(f"registry needs n >= 1, got {n}")
        if lease_s is not None and not lease_s > 0:
            raise ValueError(f"lease_s={lease_s} must be positive")
        self.n = n
        self.lease_s = lease_s
        self._leases: dict[int, PartyLease] = {}

    # -- lease lifecycle ---------------------------------------------------

    def _expiry(self, now: float) -> float:
        return float("inf") if self.lease_s is None else now + self.lease_s

    def register(self, pid: int, now: float = 0.0) -> int:
        """Mint a fresh lease for ``pid``; supersedes any prior one
        (the old session id becomes stale).  Returns the session id."""
        pid = int(pid)
        if not 0 <= pid < self.n:
            raise ValueError(
                f"party id {pid} outside the registry range(0, {self.n})")
        prev = self._leases.get(pid)
        gen = (prev.generation + 1) if prev is not None else 0
        session = ((gen & 0xFFF) << 20) | (pid + 1)
        self._leases[pid] = PartyLease(pid=pid, session=session,
                                       generation=gen,
                                       expires_at=self._expiry(now))
        return session

    def resume(self, pid: int, session: int, now: float = 0.0) -> int:
        """Re-attach a reconnecting party to its existing lease.

        The session must be the pid's *current* one and the lease still
        live — otherwise :class:`StaleSessionError` (the party must
        re-register instead, getting a fresh session id).  Every
        failure mode — including a pid that never registered at all,
        e.g. a worker reconnecting after a registry truncation — is the
        typed error (ERROR-frame path), never a bare ``KeyError``."""
        lease = self.validate(pid, session, now)
        lease.expires_at = self._expiry(now)
        return lease.session

    def renew(self, pid: int, now: float = 0.0) -> None:
        """Extend the lease of ``pid`` (called on every valid frame)."""
        lease = self._leases.get(int(pid))
        if lease is not None:
            lease.expires_at = self._expiry(now)

    def validate(self, pid: int, session: int, now: float = 0.0, *,
                 enforce_expiry: bool = True) -> PartyLease:
        """Return the pid's lease, or raise :class:`StaleSessionError`
        unless ``session`` is the pid's current, unexpired lease.

        ``enforce_expiry=False`` checks identity only (current session
        id, not superseded): frames arriving on an authenticated live
        socket are themselves liveness evidence, so the coordinator's
        per-frame gate must not evict a party that merely went quiet
        (e.g. a long local JIT compile) — expiry gates *resume* after a
        reconnect and the :meth:`eligible` sampling pool, where silence
        genuinely means absence."""
        pid = int(pid)
        lease = self._leases.get(pid)
        if lease is None:
            raise StaleSessionError(
                f"party {pid} presented session {session:#x} but holds "
                "no registration lease — re-register with a fresh HELLO")
        if int(session) != lease.session:
            raise StaleSessionError(
                f"party {pid} presented stale session {session:#x}; the "
                f"current lease is {lease.session:#x} (generation "
                f"{lease.generation})")
        if enforce_expiry and now > lease.expires_at:
            raise StaleSessionError(
                f"party {pid} session {session:#x} lease expired "
                f"{now - lease.expires_at:.3f}s ago — re-register with "
                "a fresh HELLO")
        return lease

    # -- membership views --------------------------------------------------

    def session_of(self, pid: int) -> int | None:
        lease = self._leases.get(int(pid))
        return lease.session if lease is not None else None

    def live(self, pid: int, now: float = 0.0) -> bool:
        lease = self._leases.get(int(pid))
        return lease is not None and now <= lease.expires_at

    def eligible(self, now: float = 0.0) -> set[int]:
        """Pids holding a live lease — the cohort sampling pool."""
        return {pid for pid, lease in self._leases.items()
                if now <= lease.expires_at}

    def expire(self, now: float = 0.0) -> set[int]:
        """Drop expired leases; returns the evicted pids."""
        dead = {pid for pid, lease in self._leases.items()
                if now > lease.expires_at}
        for pid in dead:
            del self._leases[pid]
        return dead

    def __len__(self) -> int:
        return len(self._leases)
