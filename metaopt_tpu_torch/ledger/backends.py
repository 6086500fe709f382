"""Ledger backends: the storage/concurrency contract behind experiments.

Port of ``metaopt_tpu/ledger/backends.py``, trimmed to the in-memory
backend. The contract kept:

- **register is create-if-absent** (duplicate id → ``DuplicateTrialError``,
  the CAS-failure signal Producer uses to drop lost suggestion races),
- **reserve is an atomic status CAS** ``new → reserved`` — exactly one worker
  wins a trial,
- **update_trial supports compare-and-swap on status** so a worker that lost
  its reservation (e.g. declared stale and re-issued) cannot clobber state.

The reference's ``MemoryLedger`` seals completed trials into a columnar
archive; here completed trials stay resident. The archive and the file,
native and coordinator backends are not ported yet.
"""

from __future__ import annotations

import heapq
import threading
import uuid
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from metaopt_tpu_torch.utils.registry import Registry

ledger_registry: Registry = Registry("ledger backend")


class DuplicateTrialError(RuntimeError):
    """Raised when registering a trial whose id already exists (lost race)."""


class DuplicateExperimentError(RuntimeError):
    """Raised when two creators race on the same experiment name."""


class LedgerBackend(ABC):
    """Storage + concurrency contract. All methods are atomic per call."""

    #: Time source for heartbeat stamps and the stale sweep.
    clock: Clock = SYSTEM_CLOCK

    # -- experiment documents --------------------------------------------
    @abstractmethod
    def create_experiment(self, config: Dict[str, Any]) -> None:
        """Create the experiment doc; raise DuplicateExperimentError if present."""

    @abstractmethod
    def load_experiment(self, name: str) -> Optional[Dict[str, Any]]: ...

    @abstractmethod
    def update_experiment(self, name: str, patch: Dict[str, Any]) -> None: ...

    @abstractmethod
    def list_experiments(self) -> List[str]: ...

    # -- trials -----------------------------------------------------------
    @abstractmethod
    def register(self, trial: Trial) -> None:
        """Insert a new trial; raise DuplicateTrialError on id collision."""

    @abstractmethod
    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        """Atomically flip one ``new`` trial to ``reserved`` for ``worker``."""

    @abstractmethod
    def update_trial(
        self,
        trial: Trial,
        expected_status: Optional[str] = None,
        expected_worker: Optional[str] = None,
    ) -> bool:
        """Write back a trial doc. With ``expected_status``/``expected_worker``,

        only if the stored fields match (CAS); returns False on CAS failure.
        ``expected_worker`` guards the ABA case where a stale reservation was
        released and re-issued to another worker — the old owner's write must
        not clobber the new owner's state.
        """

    @abstractmethod
    def heartbeat(self, experiment: str, trial_id: str, worker: str) -> bool:
        """Refresh the reservation heartbeat; False if no longer ours."""

    @abstractmethod
    def get(self, experiment: str, trial_id: str) -> Optional[Trial]: ...

    @abstractmethod
    def fetch(
        self, experiment: str, status: Optional[str | tuple] = None
    ) -> List[Trial]: ...

    def count(self, experiment: str, status: Optional[str | tuple] = None) -> int:
        return len(self.fetch(experiment, status))

    def fetch_completed_since(self, experiment: str, cursor=None):
        """``(newly_completed_trials, next_cursor)`` — incremental observe.

        This default returns the full completed set with ``None`` (no
        incremental support — correct, just slower); callers rely on the
        algorithms' observe-dedup for idempotence.
        """
        return self.fetch(experiment, "completed"), None

    def release_stale(self, experiment: str, timeout_s: float) -> List[Trial]:
        """Re-free reserved trials whose heartbeat lapsed (dead worker)."""
        now = self.clock.time()
        released = []
        for t in self.fetch(experiment, "reserved"):
            if t.heartbeat is not None and now - t.heartbeat > timeout_s:
                stale_owner = t.worker
                t.status = "new"
                t.worker = None
                t.start_time = None
                t.heartbeat = None
                if self.update_trial(
                    t, expected_status="reserved", expected_worker=stale_owner
                ):
                    released.append(t)
        return released


@ledger_registry.register("memory")
class MemoryLedger(LedgerBackend):
    """Dict + lock: the in-process ledger for single-process runs."""

    def __init__(self, **_: Any) -> None:
        self._lock = threading.RLock()
        self._experiments: Dict[str, Dict[str, Any]] = {}
        self._trials: Dict[str, Dict[str, Trial]] = {}
        #: per-experiment status → trial-id set (count/reserve off the index,
        #: not a scan: is_done polls count() every workon cycle)
        self._status_ids: Dict[str, Dict[str, set]] = {}
        #: per-experiment min-heap of (submit_time, id) over 'new' trials,
        #: lazily validated against the status set on pop
        self._new_heap: Dict[str, List[Any]] = {}
        #: per-experiment completion order — backs fetch_completed_since
        self._completed_log: Dict[str, List[str]] = {}
        #: instance identity baked into cursors: a cursor minted against
        #: another instance triggers a full refetch
        self._epoch = uuid.uuid4().hex

    def create_experiment(self, config: Dict[str, Any]) -> None:
        name = config["name"]
        with self._lock:
            if name in self._experiments:
                raise DuplicateExperimentError(name)
            self._experiments[name] = dict(config)
            self._trials[name] = {}
            self._status_ids[name] = {}
            self._new_heap[name] = []
            self._completed_log[name] = []

    def load_experiment(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            doc = self._experiments.get(name)
            return dict(doc) if doc else None

    def update_experiment(self, name: str, patch: Dict[str, Any]) -> None:
        with self._lock:
            if name not in self._experiments:
                raise KeyError(name)
            self._experiments[name].update(patch)

    def list_experiments(self) -> List[str]:
        with self._lock:
            return sorted(self._experiments)

    def _move(self, experiment: str, tid: str, old: Optional[str],
              new: str) -> None:
        idx = self._status_ids.setdefault(experiment, {})
        if old is not None and old != new:
            idx.get(old, set()).discard(tid)
        idx.setdefault(new, set()).add(tid)
        if new == "new":
            stored = self._trials.get(experiment, {}).get(tid)
            heapq.heappush(
                self._new_heap.setdefault(experiment, []),
                ((stored.submit_time or 0) if stored else 0, tid),
            )
        if new == "completed" and old != "completed":
            self._completed_log.setdefault(experiment, []).append(tid)

    def register(self, trial: Trial) -> None:
        with self._lock:
            exp = self._trials.setdefault(trial.experiment, {})
            if trial.id in exp:
                raise DuplicateTrialError(trial.id)
            exp[trial.id] = trial.clone()
            self._move(trial.experiment, trial.id, None, trial.status)

    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        with self._lock:
            new_ids = self._status_ids.get(experiment, {}).get("new")
            if not new_ids:
                return None
            exp = self._trials[experiment]
            heap = self._new_heap.get(experiment, [])
            while heap:
                _, tid = heapq.heappop(heap)
                if tid in new_ids:  # else: stale heap entry
                    t = exp[tid]
                    t.transition("reserved")
                    t.worker = worker
                    self._move(experiment, tid, "new", "reserved")
                    return t.clone()
        return None

    def update_trial(
        self,
        trial: Trial,
        expected_status: Optional[str] = None,
        expected_worker: Optional[str] = None,
    ) -> bool:
        with self._lock:
            exp = self._trials.get(trial.experiment, {})
            stored = exp.get(trial.id)
            if stored is None:
                return False
            if expected_status is not None and stored.status != expected_status:
                return False
            if expected_worker is not None and stored.worker != expected_worker:
                return False
            exp[trial.id] = trial.clone()
            self._move(trial.experiment, trial.id, stored.status, trial.status)
            return True

    def heartbeat(self, experiment: str, trial_id: str, worker: str) -> bool:
        with self._lock:
            t = self._trials.get(experiment, {}).get(trial_id)
            if t is None or t.status != "reserved" or t.worker != worker:
                return False
            t.heartbeat = self.clock.time()
            return True

    def get(self, experiment: str, trial_id: str) -> Optional[Trial]:
        with self._lock:
            t = self._trials.get(experiment, {}).get(trial_id)
            return t.clone() if t is not None else None

    def fetch(self, experiment: str, status=None) -> List[Trial]:
        statuses = (status,) if isinstance(status, str) else status
        with self._lock:
            exp = self._trials.get(experiment, {})
            if statuses is None:
                out = [t.clone() for t in exp.values()]
            else:
                idx = self._status_ids.get(experiment, {})
                out = [exp[i].clone() for s in statuses
                       for i in idx.get(s, ())]
            out.sort(key=lambda t: (t.submit_time or 0, t.id))
            return out

    def count(self, experiment: str, status=None) -> int:
        statuses = (status,) if isinstance(status, str) else status
        with self._lock:
            if statuses is None:
                return len(self._trials.get(experiment, {}))
            idx = self._status_ids.get(experiment, {})
            return sum(len(idx.get(s, ())) for s in statuses)

    def fetch_completed_since(self, experiment: str, cursor=None):
        with self._lock:
            log_ = self._completed_log.get(experiment, [])
            start = 0
            if (cursor and cursor[0] == self._epoch
                    and int(cursor[1]) <= len(log_)):
                start = int(cursor[1])
            exp = self._trials.get(experiment, {})
            out = []
            for tid in log_[start:]:
                t = exp.get(tid)
                # a revived (completed→new) trial stays in the log; skip it
                # until it re-completes and re-appends
                if t is not None and t.status == "completed":
                    out.append(t.clone())
            out.sort(key=lambda t: (t.submit_time or 0, t.id))
            return out, [self._epoch, len(log_)]


def ledger_from_spec(spec: str) -> LedgerBackend:
    """Build a backend from the user-facing spec string.

    Only ``"memory"`` is ported; the reference's directory, ``native:``,
    ``file:`` and ``coord://`` specs raise until their backends are.
    """
    if spec == "memory":
        return ledger_registry.get("memory")()
    raise NotImplementedError(
        f"ledger spec {spec!r}: only 'memory' is ported so far "
        "(file/native/coord ledgers are queued in ROADMAP.md)"
    )
