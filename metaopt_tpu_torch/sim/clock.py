"""Virtual clock (port of ``metaopt_tpu/sim/clock.py``): both timelines of ``utils/clock.py`` in lockstep.

The simulator owns one ``VirtualClock`` shared by the CoordServer, its
WAL, the ledger backend, and Trial stamping. ``advance_to`` is called
only by the event loop between events, so every component observes a
single coherent "now" for the whole handling of one event — the
discrete-event contract.
"""

from __future__ import annotations

import threading

from metaopt_tpu_torch.utils.clock import Clock


class VirtualClock(Clock):
    """Settable clock whose wall and monotonic views move together.

    ``monotonic()`` is seconds since simulation start; ``time()`` is the
    same value offset by a fixed epoch, so persisted stamps (trial
    heartbeats, snapshot ``ts``) look like plausible wall times while
    staying a pure function of simulated progress — the determinism
    contract (same seed → byte-identical event logs) depends on no real
    clock ever leaking into simulated state.

    ``sleep`` ADVANCES virtual time instead of blocking: a component
    that sleeps (WAL group window, produce coalescer window) costs
    simulated time, not wall time. The lock makes reads/writes safe if
    a test mixes a virtual clock with a real threaded server; the
    single-threaded simulator never contends on it.
    """

    #: fixed, arbitrary epoch for the wall view (never derived from the
    #: real clock — that would break replay determinism)
    DEFAULT_EPOCH = 1_700_000_000.0

    def __init__(self, start: float = 0.0,
                 epoch: float = DEFAULT_EPOCH) -> None:
        self._lock = threading.Lock()
        self._now = float(start)
        self.epoch = float(epoch)

    def time(self) -> float:
        with self._lock:
            return self.epoch + self._now

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.advance(seconds)

    # -- simulator controls ----------------------------------------------
    def advance(self, dt: float) -> float:
        """Move virtual time forward by ``dt`` seconds; returns new now."""
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}")
        with self._lock:
            self._now += dt
            return self._now

    def advance_to(self, t: float) -> float:
        """Move virtual time to ``t`` (monotonic view); never backwards —
        an event heap may legally pop two events at the same instant."""
        with self._lock:
            if t > self._now:
                self._now = t
            return self._now
