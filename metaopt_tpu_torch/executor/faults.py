"""Fault injection for executor tests.

Port of ``metaopt_tpu/executor/faults.py``. The port's consumers are the
subprocess executor's three kinds, so failure-detection paths — broken
trials, lost heartbeats, spawn failures — are testable deterministically
instead of waiting for real preemptions:

    from metaopt_tpu_torch.executor.faults import faults
    faults.arm("kill_trial", times=1)        # next trial gets SIGTERMed
    faults.arm("drop_heartbeat", times=2)    # next 2 heartbeats report lost
    faults.arm("spawn_fail", times=1)        # next spawn errors out

or via env (picked up at import, for subprocess-launched workers):

    METAOPT_TPU_FAULTS="kill_trial:1,drop_heartbeat:2"
    METAOPT_TPU_FAULTS="kill_trial:1@5"           # skip 5 firings, then fire
    METAOPT_TPU_FAULTS="drop_heartbeat:p=0.01@7"  # 1% per firing, seed 7

Each armed rule fires ``times`` times then disarms; an optional ``@skip``
suffix (or ``arm(..., skip=N)``) swallows the first N firings first.

The second spec form, ``kind:p=<prob>@<seed>`` (or
``arm_probability(kind, p, seed)``), arms a SEEDED probabilistic rule:
every ``fire(kind)`` call flips a coin from a per-kind
``random.Random(seed)`` stream and fires with probability ``p``,
indefinitely. The stream is seeded per kind and advanced once per
``fire`` call, so a whole fault sweep is reproducible from the seed
alone. Deterministic ``times@skip`` rules take precedence when both are
armed for the same kind.

``fire(kind)`` is the single hook executors consult; it is thread-safe and
cheap when nothing is armed (one dict lookup).
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Optional

log = logging.getLogger(__name__)

FAULTS_ENV = "METAOPT_TPU_FAULTS"


class FaultInjector:
    def __init__(self, spec: Optional[str] = None) -> None:
        """Parse ``spec`` (default: the ``METAOPT_TPU_FAULTS`` env var).

        An explicit ``spec`` builds a private injector that cannot leak
        into (or be polluted by) the process-global instance.
        """
        self._lock = threading.Lock()
        self._armed: Dict[str, int] = {}
        self._skip: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        #: kind → (probability, seeded stream) for ``p=`` rules
        self._prob: Dict[str, tuple] = {}
        if spec is None:
            spec = os.environ.get(FAULTS_ENV, "")
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, rule = part.partition(":")
            times, _, suffix = rule.partition("@")
            try:
                if times.startswith("p="):
                    # probabilistic: kind:p=<prob>@<seed> (seed optional)
                    self.arm_probability(
                        kind, float(times[2:]),
                        seed=int(suffix) if suffix else 0)
                else:
                    self._armed[kind] = int(times) if times else 1
                    if suffix:
                        self._skip[kind] = int(suffix)
            except ValueError:
                # a chaos-test env typo must not kill the worker at import
                log.warning("ignoring malformed %s entry %r", FAULTS_ENV, part)

    def arm(self, kind: str, times: int = 1, skip: int = 0) -> None:
        """Arm ``kind`` to fire ``times`` times, after swallowing its first
        ``skip`` firings."""
        with self._lock:
            self._armed[kind] = self._armed.get(kind, 0) + times
            if skip:
                self._skip[kind] = self._skip.get(kind, 0) + skip

    def arm_probability(self, kind: str, p: float, seed: int = 0) -> None:
        """Arm ``kind`` to fire with probability ``p`` on EVERY consult.

        The coin stream is ``random.Random(seed)`` salted with the kind
        name, advanced exactly once per ``fire(kind)`` call — so a sweep's
        entire fault pattern replays bit-identically from (spec, seed)
        regardless of what other kinds are armed. ``p<=0`` disarms.
        """
        with self._lock:
            if p <= 0:
                self._prob.pop(kind, None)
            else:
                self._prob[kind] = (
                    min(1.0, p), random.Random(f"{kind}@{seed}"))

    def fire(self, kind: str) -> bool:
        """Consume one charge of ``kind``; True = the fault should happen."""
        if not self._armed and not self._prob:  # fast path: nothing armed
            return False
        with self._lock:
            n = self._armed.get(kind, 0)
            if n <= 0:
                rule = self._prob.get(kind)
                if rule is None:
                    return False
                p, rng = rule
                # always advance the stream: the draw sequence must be a
                # pure function of how many times this kind was consulted
                if rng.random() >= p:
                    return False
                self._fired[kind] = self._fired.get(kind, 0) + 1
                log.warning("fault injected (p=%g): %s", p, kind)
                return True
            s = self._skip.get(kind, 0)
            if s > 0:
                self._skip[kind] = s - 1
                return False
            if n == 1:
                del self._armed[kind]
            else:
                self._armed[kind] = n - 1
            self._fired[kind] = self._fired.get(kind, 0) + 1
        log.warning("fault injected: %s", kind)
        return True

    def fired(self, kind: str) -> int:
        with self._lock:
            return self._fired.get(kind, 0)

    def reset(self) -> None:
        with self._lock:
            self._armed.clear()
            self._skip.clear()
            self._fired.clear()
            self._prob.clear()


#: process-global injector — executors consult this instance
faults = FaultInjector()
