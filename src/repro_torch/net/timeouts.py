"""Deadline/dropout detection with an injectable clock.

A copy of ``repro/net/timeouts.py``.

The coordinator watches two distinct failure signals per protocol
stage:

* **dropout** — a party's TCP stream hit EOF / reset: deterministic,
  immediate, no clock involved (a killed process closes its socket).
* **straggler** — a party is still connected but has not completed its
  expected messages by the stage deadline, measured on an *injectable*
  monotonic clock so the state machine is unit-testable without
  sleeping (``ManualClock``) and free of wall-clock flakiness.

:class:`StageMonitor` is a pure state machine — no asyncio, no sockets
— the coordinator feeds it events and polls ``expired()``; its final
``dropped`` / ``straggled`` sets are handed to
``fl.faults.resolve_outcome`` so the wire path and the simulation share
one quorum/outcome brain.
"""

from __future__ import annotations

import time
from typing import Iterable

from .wire import WireTimeoutError

__all__ = ["ManualClock", "StageMonitor", "SystemClock"]


class SystemClock:
    """Real monotonic time."""

    def monotonic(self) -> float:
        return time.monotonic()


class ManualClock:
    """Deterministic clock for tests: advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def monotonic(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot rewind a monotonic clock by {dt}")
        self._now += dt


class StageMonitor:
    """Tracks one protocol stage's expected completions per party.

    Args:
      expected: party ids the stage is waiting on.
      deadline_s: stage budget from ``start()`` on the injected clock;
        ``None`` disables straggler detection (EOF still detects
        dropouts).
      clock: object with ``monotonic() -> float``.
    """

    def __init__(self, expected: Iterable[int], deadline_s: float | None,
                 clock=None):
        self.expected = set(int(i) for i in expected)
        self.deadline_s = deadline_s
        self.clock = clock if clock is not None else SystemClock()
        self._done: set[int] = set()
        self.dropped: set[int] = set()
        self.straggled: set[int] = set()
        self._t0: float | None = None

    # -- events -----------------------------------------------------------

    def start(self) -> "StageMonitor":
        self._t0 = self.clock.monotonic()
        return self

    def completed(self, party: int) -> None:
        if party in self.expected:
            self._done.add(party)

    def eof(self, party: int) -> None:
        """The party's stream closed — a deterministic dropout."""
        if party in self.expected and party not in self._done:
            self.dropped.add(party)

    # -- state ------------------------------------------------------------

    def pending(self) -> set[int]:
        return self.expected - self._done - self.dropped - self.straggled

    def settled(self) -> bool:
        """Every expected party completed, dropped, or straggled."""
        return not self.pending()

    def remaining_s(self) -> float | None:
        if self.deadline_s is None or self._t0 is None:
            return None
        return self.deadline_s - (self.clock.monotonic() - self._t0)

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0

    def expire_pending(self) -> set[int]:
        """Deadline passed: pending parties become stragglers."""
        late = self.pending()
        self.straggled |= late
        return late

    def check(self) -> None:
        """Poll hook: fold an expired deadline into the straggler set."""
        if self.pending() and self.expired():
            self.expire_pending()

    def require_any_progress(self) -> None:
        """Raise if *everyone* failed — the stage cannot proceed."""
        if self.expected and not self._done:
            raise WireTimeoutError(
                f"stage got no completions: dropped={sorted(self.dropped)} "
                f"straggled={sorted(self.straggled)}")
