"""Injectable time source (port of ``metaopt_tpu/utils/clock.py``).

Every component that stamps or compares times goes through a ``Clock``
instead of calling :mod:`time` directly. ``time()`` is wall-clock seconds
since the epoch, for stamps that outlive the process (trial submit,
heartbeat and end times); ``monotonic()`` is for intervals within one
process.
"""

from __future__ import annotations

import time as _time


class Clock:
    """Real time source; the default for every production code path.

    Thin, allocation-free pass-throughs to :mod:`time`.  Subclasses
    override all three methods; callers must never cache the underlying
    functions.
    """

    def time(self) -> float:
        """Wall-clock seconds since the epoch (persistent stamps)."""
        return _time.time()

    def monotonic(self) -> float:
        """Monotonic seconds (in-process intervals and deadlines)."""
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        """Block for ``seconds``; virtual clocks make this free."""
        if seconds > 0:
            _time.sleep(seconds)


#: Process-wide default.  Components take ``clock=None`` and fall back to
#: this so the common path never pays for plumbing it explicitly.
SYSTEM_CLOCK = Clock()
