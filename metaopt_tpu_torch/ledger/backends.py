"""Ledger backends: the storage/concurrency contract behind experiments.

Port of ``metaopt_tpu/ledger/backends.py``: the in-memory and the file
backends, and the spec grammar that picks one (the native engine's backend
is :mod:`metaopt_tpu_torch.ledger.native`). The contract kept:

- **register is create-if-absent** (duplicate id → ``DuplicateTrialError``,
  the CAS-failure signal Producer uses to drop lost suggestion races),
- **reserve is an atomic status CAS** ``new → reserved`` — exactly one worker
  wins a trial,
- **update_trial supports compare-and-swap on status** so a worker that lost
  its reservation (e.g. declared stale and re-issued) cannot clobber state.

:class:`MemoryLedger` seals completed trials into the columnar archive
(:mod:`metaopt_tpu_torch.ledger.archive`), as the reference's does.
:class:`FileLedger` keeps the reference's on-disk layout exactly, so either
package reads the other's file ledgers. The coordinator RPC client
(:mod:`metaopt_tpu_torch.coord.client_backend`) is registered under
``"coord"``; ``coord://host:port`` names it.
"""

from __future__ import annotations

import fcntl
import heapq
import itertools
import json
import logging
import os
import threading
import urllib.parse
import uuid
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

from metaopt_tpu_torch.ledger.archive import (CompletedBatch, ExperimentArchive,
                                              _id_key)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from metaopt_tpu_torch.utils.registry import Registry

log = logging.getLogger(__name__)

#: MemoryLedger instance counter (cursor epochs; see fetch_completed_since)
_MEM_EPOCHS = itertools.count()

ledger_registry: Registry = Registry("ledger backend")


class DuplicateTrialError(RuntimeError):
    """Raised when registering a trial whose id already exists (lost race)."""


class DuplicateExperimentError(RuntimeError):
    """Raised when two creators race on the same experiment name."""


class AdmissionError(RuntimeError):
    """Raised when a multi-tenant coordinator refuses ``create_experiment``
    past its configured limits (``max_experiments`` /
    ``max_experiments_per_tenant``) — the admission-control gate. Not a
    retryable race: the caller must shed load or raise its quota."""


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

    def export_docs(self, experiment: str) -> List[Dict[str, Any]]:
        """Raw trial documents — the snapshot/archive path.

        Backends that store documents directly override this to skip the
        Trial round-trip (MemoryLedger does one conversion instead of
        three); the default is correct everywhere.
        """
        return [t.to_dict() for t in self.fetch(experiment)]

    def delete_experiment(self, name: str) -> bool:
        """Remove an experiment and its trials; False if unsupported.

        Optional: used by housekeeping (``db rm``, ``db load --resolve
        overwrite``, ``db test``'s scratch cleanup). Backends where
        deletion is unsafe or unimplemented return False and the caller
        leaves the documents in place.
        """
        return False

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

    def put_trial(self, trial: Trial) -> None:
        """Upsert: register if absent, else overwrite unconditionally.

        The redo-replay primitive behind the coordinator's WAL recovery
        (:mod:`metaopt_tpu_torch.coord.wal`): nondeterministic mutations
        (``reserve``, ``release_stale``) journal their RESULTING document
        state, and replaying that state must be idempotent — applying the
        same record twice, or over a snapshot that already reflects it,
        lands on the identical document. Not part of the client-facing
        contract (workers keep using the CAS-guarded ``update_trial``).
        """
        try:
            self.register(trial)
        except DuplicateTrialError:
            self.update_trial(trial)


class _CompletedLog:
    """Append-only completion-order log of trial ids.

    A plain list of id strings costs ~80 bytes per entry at 1M trials
    (the 24-char str plus its slot); this stores the ids in a growable
    fixed-width ``S24`` byte array (~24 bytes/entry) and materializes
    strings lazily at iteration. Ids the fixed shape can't round-trip
    (see :func:`metaopt_tpu_torch.ledger.archive._id_key`) go to a side dict.
    Same contract as the list it replaces: ``len`` is the cursor space,
    entries are immutable once appended.
    """

    __slots__ = ("_buf", "_len", "_odd")

    def __init__(self) -> None:
        self._buf = np.empty(64, dtype="S24")
        self._len = 0
        self._odd: Dict[int, str] = {}

    def __len__(self) -> int:
        return self._len

    def append(self, tid: str) -> None:
        if self._len == len(self._buf):
            grown = np.empty(len(self._buf) * 2, dtype="S24")
            grown[:self._len] = self._buf
            self._buf = grown
        key = _id_key(tid)
        if key is None:
            self._odd[self._len] = tid
            key = b""
        self._buf[self._len] = key
        self._len += 1

    def iter_from(self, start: int):
        for i in range(start, self._len):
            odd = self._odd.get(i)
            yield odd if odd is not None else self._buf[i].decode()


@ledger_registry.register("memory")
class MemoryLedger(LedgerBackend):
    """Dict + lock: the in-process ledger for single-process runs."""

    def __init__(self, archive_completed: bool = True,
                 archive_segment_rows: int = 4096, **_: Any) -> None:
        self._lock = threading.RLock()
        self._experiments: Dict[str, Dict[str, Any]] = {}
        #: RESIDENT trials only — an id lives in exactly one of this table
        #: or the experiment's archive, never both. Completed trials move
        #: to the archive (below); everything mutable stays here.
        self._trials: Dict[str, Dict[str, Trial]] = {}
        #: columnar archive per experiment (ledger/archive.py): completed
        #: trials are terminal, so they seal into structure-of-arrays
        #: segments instead of sitting as resident Python objects — flat
        #: RSS at 1M+ trials. When it is on, the archive's own id index
        #: doubles as the "completed" status index (_move skips the set)
        #: and the completed log stores fixed-width bytes, not id strings
        #: — the per-trial Python-object footprint is what the archive
        #: exists to eliminate.
        self._archive_completed = bool(archive_completed)
        self._segment_rows = int(archive_segment_rows)
        self._archives: Dict[str, ExperimentArchive] = {}
        #: per-experiment status → trial-id set (count/reserve off the
        #: index, not a scan: is_done polls count() every workon cycle)
        self._status_ids: Dict[str, Dict[str, set]] = {}
        #: per-experiment min-heap of (submit_time, id) over 'new' trials:
        #: a producer mints whole pools ahead of the workers, so the new
        #: set is O(registered-not-yet-run) — min() over it measured 1.9k
        #: entries per reserve mid-sweep. Lazy-validated against the
        #: status set on pop (requeued ids may appear twice; dead entries
        #: are skipped), so reserve is O(log n) amortized.
        self._new_heap: Dict[str, List[Any]] = {}
        #: per-experiment completion order (trial ids, appended on every
        #: transition INTO completed) — backs fetch_completed_since
        self._completed_log: Dict[str, _CompletedLog] = {}
        #: instance identity baked into cursors: a cursor minted against
        #: another instance triggers a full refetch. Random, not
        #: pid+counter: a restarted process reuses pids and module counters
        #: restart, which would alias the old incarnation exactly
        self._epoch = uuid.uuid4().hex
        #: per-experiment generation (bumped on create): a cursor from a
        #: DELETED-and-recreated experiment must not alias the new history
        #: once the new log catches up to the old cursor position
        self._exp_gen: Dict[str, int] = {}

    def create_experiment(self, config: Dict[str, Any]) -> None:
        name = config["name"]
        with self._lock:
            if name in self._experiments:
                raise DuplicateExperimentError(name)
            self._experiments[name] = dict(config)
            # a fresh experiment must not inherit ghost trials left by a
            # register that raced a delete_experiment of the same name
            self._trials[name] = {}
            self._archives.pop(name, None)
            self._status_ids[name] = {}
            self._new_heap[name] = []
            self._completed_log[name] = _CompletedLog()
            self._exp_gen[name] = next(_MEM_EPOCHS)

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

    def delete_experiment(self, name: str) -> bool:
        with self._lock:
            existed = name in self._experiments
            self._experiments.pop(name, None)
            self._trials.pop(name, None)
            self._archives.pop(name, None)
            self._status_ids.pop(name, None)
            self._new_heap.pop(name, None)
            self._completed_log.pop(name, None)
            self._exp_gen.pop(name, None)
            return existed

    # mtpu: holds(_lock)
    def _index(self, experiment: str) -> Dict[str, set]:
        return self._status_ids.setdefault(experiment, {})

    # mtpu: holds(_lock)
    def _arch(self, experiment: str) -> ExperimentArchive:
        """Write-path accessor (creates on first completed trial); read
        paths use ``self._archives.get`` so they never resurrect entries
        for deleted experiment names."""
        arch = self._archives.get(experiment)
        if arch is None:
            arch = ExperimentArchive(experiment, self._segment_rows)
            self._archives[experiment] = arch
        return arch

    # mtpu: holds(_lock)
    def _move(self, experiment: str, tid: str, old: Optional[str],
              new: str) -> None:
        idx = self._index(experiment)
        if old is not None and old != new:
            idx.get(old, set()).discard(tid)
        if new == "completed" and self._archive_completed:
            # the archive's own id index IS the completed index — a
            # per-id set entry here would duplicate it (~33 bytes/trial
            # at 1M); count/fetch consult the archive instead
            pass
        else:
            idx.setdefault(new, set()).add(tid)
        if new == "new":
            stored = self._trials.get(experiment, {}).get(tid)
            heapq.heappush(
                self._new_heap.setdefault(experiment, []),
                ((stored.submit_time or 0) if stored else 0, tid),
            )

    def register(self, trial: Trial) -> None:
        with self._lock:
            exp = self._trials.setdefault(trial.experiment, {})
            arch = self._archives.get(trial.experiment)
            if trial.id in exp or (arch is not None
                                   and arch.contains(trial.id)):
                raise DuplicateTrialError(trial.id)
            if trial.status == "completed" and self._archive_completed:
                # db load / replay of finished trials: straight to archive
                self._arch(trial.experiment).append(trial.to_dict())
            else:
                exp[trial.id] = trial.clone()
            self._move(trial.experiment, trial.id, None, trial.status)
            if trial.status == "completed":  # db load of finished trials
                self._completed_log.setdefault(
                    trial.experiment, _CompletedLog()
                ).append(trial.id)

    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        with self._lock:
            # .get, not _index(): read paths must not resurrect entries
            # for deleted/unknown experiment names
            new_ids = self._status_ids.get(experiment, {}).get("new")
            if not new_ids:
                return None
            exp = self._trials[experiment]
            heap = self._new_heap.get(experiment, [])
            while heap:
                _, tid = heapq.heappop(heap)
                if tid in new_ids and tid in exp:  # else: stale heap entry
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
                return self._update_archived(
                    trial, expected_status, expected_worker
                )
            if expected_status is not None and stored.status != expected_status:
                return False
            if expected_worker is not None and stored.worker != expected_worker:
                return False
            if trial.status == "completed" and stored.status != "completed":
                self._completed_log.setdefault(
                    trial.experiment, _CompletedLog()
                ).append(trial.id)
            if trial.status == "completed" and self._archive_completed:
                # terminal: seal into the columnar archive, drop the
                # resident object (the whole point — flat RSS per trial)
                del exp[trial.id]
                self._arch(trial.experiment).append(trial.to_dict())
            else:
                exp[trial.id] = trial.clone()
            self._move(trial.experiment, trial.id, stored.status, trial.status)
            return True

    # mtpu: holds(_lock)
    def _update_archived(
        self,
        trial: Trial,
        expected_status: Optional[str],
        expected_worker: Optional[str],
    ) -> bool:
        """``update_trial`` against an archived (completed) document: CAS
        checks run against the archive's columns; a write that keeps the
        trial completed re-archives it, anything else (``db set
        status=new`` revival, replay of an older state) pulls it back to
        the resident table."""
        arch = self._archives.get(trial.experiment)
        if arch is None or not arch.contains(trial.id):
            return False
        if expected_status is not None and expected_status != "completed":
            return False
        if (expected_worker is not None
                and arch.worker_of(trial.id) != expected_worker):
            return False
        if trial.status == "completed":
            # stays terminal: no status move, no completed-log append
            arch.replace(trial.id, trial.to_dict())
            return True
        arch.discard(trial.id)
        self._trials.setdefault(trial.experiment, {})[trial.id] = \
            trial.clone()
        self._move(trial.experiment, trial.id, "completed", trial.status)
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
            if t is not None:
                return t.clone()
            arch = self._archives.get(experiment)
            return arch.get_trial(trial_id) if arch is not None else None

    def fetch(self, experiment: str, status=None) -> List[Trial]:
        statuses = (status,) if isinstance(status, str) else status
        with self._lock:
            exp = self._trials.get(experiment, {})
            arch = self._archives.get(experiment)
            if statuses is None:
                out = [t.clone() for t in exp.values()]
                if arch is not None:
                    out.extend(Trial.from_dict_trusted(d)
                               for d in arch.iter_docs())
            else:  # index: touch only matching trials, not the whole table
                idx = self._status_ids.get(experiment, {})
                ids = set().union(*(idx.get(s, set()) for s in statuses)) \
                    if statuses else set()
                out = []
                for i in ids:
                    t = exp.get(i)
                    if t is not None:
                        out.append(t.clone())
                    elif arch is not None:
                        at = arch.get_trial(i)
                        if at is not None:
                            out.append(at)
                if ("completed" in statuses and arch is not None
                        and self._archive_completed):
                    # archived ids have no index entries (_move) — the
                    # archive enumerates them itself
                    out.extend(Trial.from_dict_trusted(d)
                               for d in arch.iter_docs())
            out.sort(key=lambda t: (t.submit_time or 0, t.id))
            return out

    def count(self, experiment: str, status=None) -> int:
        # O(1) off the status index — is_done polls count() every workon
        # cycle, which made the scan version O(n²) over an experiment
        statuses = (status,) if isinstance(status, str) else status
        with self._lock:
            if statuses is None:
                arch = self._archives.get(experiment)
                return (len(self._trials.get(experiment, {}))
                        + (len(arch) if arch is not None else 0))
            idx = self._status_ids.get(experiment, {})
            total = sum(len(idx.get(s, ())) for s in statuses)
            if "completed" in statuses and self._archive_completed:
                arch = self._archives.get(experiment)
                if arch is not None:
                    total += len(arch)
            return total

    def export_docs(self, experiment: str) -> List[Dict[str, Any]]:
        """Raw trial documents, one conversion each — the snapshot path.

        ``fetch`` deep-copies through from_dict(to_dict(...)) and the
        snapshot then calls to_dict again: three conversions per trial
        under the coordinator's global lock. This does one. Archived
        trials decode from their columns — evict/hand-off capture stays
        bit-identical to the all-resident path.
        """
        with self._lock:
            out = [t.to_dict() for t in
                   self._trials.get(experiment, {}).values()]
            arch = self._archives.get(experiment)
            if arch is not None:
                out.extend(arch.iter_docs())
            return out

    def export_mutable_docs(self, experiment: str) -> List[Dict[str, Any]]:
        """Docs NOT covered by sealed segments: resident trials plus the
        archive's unsealed head — the part an incremental snapshot must
        reserialize every time (everything else is referenced by segment
        id; see :meth:`archive_segment_refs`)."""
        with self._lock:
            out = [t.to_dict() for t in
                   self._trials.get(experiment, {}).values()]
            arch = self._archives.get(experiment)
            if arch is not None:
                out.extend(arch.head_docs())
            return out

    def archive_segment_refs(self, experiment: str) -> List[Dict[str, Any]]:
        """Sealed-segment manifest entries (id, rows, dead list) for the
        incremental snapshot; empty when nothing sealed."""
        with self._lock:
            arch = self._archives.get(experiment)
            return arch.segment_refs() if arch is not None else []

    def export_archive_segment(
        self, experiment: str, seg_id: str
    ) -> List[Dict[str, Any]]:
        """All rows of one sealed segment (including dead ones — the
        manifest's dead list filters at restore). Immutable: written to
        its snapshot file exactly once."""
        with self._lock:
            arch = self._archives.get(experiment)
            if arch is None:
                raise KeyError(f"no archive for experiment {experiment!r}")
            return arch.export_segment_docs(seg_id)

    def seal_archive(self, experiment: str) -> None:
        """Force-seal the archive head (tests; pre-handoff determinism)."""
        with self._lock:
            arch = self._archives.get(experiment)
            if arch is not None:
                arch.seal()

    def archive_stats(self, experiment: str) -> Dict[str, Any]:
        with self._lock:
            arch = self._archives.get(experiment)
            return arch.stats() if arch is not None else {
                "live": 0, "segments": 0, "sealed_rows": 0,
                "dead_rows": 0, "head_rows": 0, "overflow_rows": 0,
            }

    def fetch_completed_since(self, experiment: str, cursor=None):
        with self._lock:
            log_ = self._completed_log.get(experiment)
            log_len = len(log_) if log_ is not None else 0
            gen = self._exp_gen.get(experiment, 0)
            start = 0
            if (cursor and cursor[0] == self._epoch
                    and int(cursor[1]) == gen
                    and int(cursor[2]) <= log_len):
                start = int(cursor[2])
            exp = self._trials.get(experiment, {})
            arch = self._archives.get(experiment)
            # entries materialize lazily (CompletedBatch): archived rows
            # travel as (segment, row) refs so the observe path can batch
            # straight off the columns without a per-trial dict round-trip
            keyed = []
            for tid in (log_.iter_from(start) if log_ is not None else ()):
                t = exp.get(tid)
                if t is not None:
                    # a revived (completed→new) trial stays in the log;
                    # skip it until it re-completes and re-appends
                    if t.status == "completed":
                        keyed.append(((t.submit_time or 0, tid),
                                      ("t", t.clone())))
                    continue
                if arch is None:
                    continue
                e = arch.entry(tid)
                if e is None:
                    continue
                if e[0] == "d":
                    st = e[1].get("submit_time")
                else:
                    st = e[1].submit_time_of(e[2])
                keyed.append(((st or 0, tid), e))
            keyed.sort(key=lambda p: p[0])
            batch = CompletedBatch([e for _, e in keyed])
            return batch, [self._epoch, gen, log_len]


# ---------------------------------------------------------------------------


@ledger_registry.register("file")
class FileLedger(LedgerBackend):
    """Directory-of-JSON ledger with flock-based atomicity.

    Layout (the reference's): ``<root>/<experiment>/experiment.json``,
    ``<root>/<experiment>/trials/<id>.json``, the status index
    ``<root>/<experiment>/trials.index.{json,log}`` and the lock file
    ``<root>/.locks/<experiment>.lock`` (experiment names percent-encoded).
    One coarse lock per experiment: every op takes it for its critical
    section. This trades throughput for simplicity — trial docs are tiny and
    trial runtimes are seconds-to-hours, so the lock is never contended in
    practice (same argument the reference makes for Mongo round-trips).
    """

    def __init__(self, path: Optional[str] = None, **_: Any) -> None:
        self.root = path or os.path.expanduser("~/.metaopt_tpu/ledger")
        os.makedirs(self.root, exist_ok=True)
        #: per-experiment parsed-index cache keyed by (snapshot stamp,
        #: log size): another process's write changes the key and forces
        #: a replay/re-read; our own writes refresh it. Purely an
        #: in-process read-amplification fix — the flock still serializes
        self._idx_cache: Dict[str, tuple] = {}
        #: trials-dir mtime_ns as of OUR last write/heal-check under the
        #: flock: an unchanged stamp proves no foreign writer touched the
        #: directory, letting reads skip the O(n) listdir heal
        self._dir_stamp: Dict[str, Optional[int]] = {}

    # -- internals --------------------------------------------------------
    def _edir(self, name: str) -> str:
        # percent-encode so distinct names can never collide on disk
        safe = urllib.parse.quote(name, safe="")
        return os.path.join(self.root, safe)

    def _locked(self, name: str):
        class _Lock:
            def __init__(self, path: str):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                self.path = path

            def __enter__(self):
                self.f = open(self.path, "a+")
                fcntl.flock(self.f, fcntl.LOCK_EX)
                return self

            def __exit__(self, *exc):
                fcntl.flock(self.f, fcntl.LOCK_UN)
                self.f.close()

        # lock files live OUTSIDE the experiment dir (<root>/.locks/) so
        # removing an experiment dir cannot fork the lock's identity under
        # a blocked waiter; a lock file is never deleted
        safe = urllib.parse.quote(name, safe="")
        return _Lock(os.path.join(self.root, ".locks", safe + ".lock"))

    @staticmethod
    def _write_json(path: str, doc: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        # atomic, deliberately not durable: FileLedger's documented
        # contract is torn-free reads (the reference's, whose coordinator
        # WAL owns durability) — an fsync here would tax every trial write
        os.replace(tmp, path)  # mtpu: lint-ok MTP001 WAL owns durability

    @staticmethod
    def _read_json(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError:
            # a crash can leave an empty/truncated file even with the
            # tmp+rename write (rename without fsync): treat as missing so
            # the callers' heal paths (index rebuild, doc skip) engage
            # instead of wedging every subsequent op on the experiment
            return None

    def _tpath(self, experiment: str, trial_id: str) -> str:
        return os.path.join(self._edir(experiment), "trials", f"{trial_id}.json")

    # -- experiment docs --------------------------------------------------
    def create_experiment(self, config: Dict[str, Any]) -> None:
        import shutil

        name = config["name"]
        with self._locked(name):
            epath = os.path.join(self._edir(name), "experiment.json")
            if os.path.exists(epath):
                raise DuplicateExperimentError(name)
            tdir = os.path.join(self._edir(name), "trials")
            if os.path.isdir(tdir):
                # ghost docs left by a removed experiment of this name:
                # a fresh experiment must not inherit them
                shutil.rmtree(tdir, ignore_errors=True)
            os.makedirs(tdir, exist_ok=True)
            self._write_json(epath, config)

    def load_experiment(self, name: str) -> Optional[Dict[str, Any]]:
        with self._locked(name):
            return self._read_json(os.path.join(self._edir(name), "experiment.json"))

    def update_experiment(self, name: str, patch: Dict[str, Any]) -> None:
        with self._locked(name):
            epath = os.path.join(self._edir(name), "experiment.json")
            doc = self._read_json(epath)
            if doc is None:
                raise KeyError(name)
            doc.update(patch)
            self._write_json(epath, doc)

    def list_experiments(self) -> List[str]:
        out = []
        for entry in sorted(os.listdir(self.root)):
            doc = self._read_json(os.path.join(self.root, entry, "experiment.json"))
            if doc and "name" in doc:
                out.append(doc["name"])
        return sorted(out)

    def delete_experiment(self, name: str) -> bool:
        import shutil

        with self._locked(name):
            epath = os.path.join(self._edir(name), "experiment.json")
            if not os.path.exists(epath):
                return False
            # the flock lives in <root>/.locks/, not in this dir, so
            # removing the dir cannot fork the lock identity under a
            # blocked waiter; only the (tiny, reusable) lock file persists
            shutil.rmtree(self._edir(name), ignore_errors=True)
            self._idx_cache.pop(name, None)
        return True

    # -- trial status index ------------------------------------------------
    # Snapshot + append-only log, maintained inside the SAME flock critical
    # sections that write trial docs:
    #   <edir>/trials.index.json: {"epoch", "statuses": {id: status},
    #       "completed_log": [ids], "new_queue": [[submit_time, id], ...]}
    #   <edir>/trials.index.log: one JSON line per status change.
    # Without the log, EVERY register/reserve/update would rewrite the
    # whole snapshot — an O(n) serialize per op. A write appends one line
    # (O(1)) and the snapshot is
    # rewritten only at compaction; readers replay the log tail over the
    # cached parse, incrementally (byte offset) when only the log grew.
    # ``new_queue`` (kept sorted by (submit_time, id)) lets reserve read
    # ONE candidate document instead of every 'new' doc. Compaction
    # preserves the epoch, so fetch_completed_since cursors survive it;
    # only a full rebuild (missing/corrupt index, file-count drift from a
    # pre-index writer) mints a fresh epoch. A fleet SHARING one file
    # ledger must upgrade together — an old writer flips
    # statuses without touching the index, which the file-count heal
    # cannot see.

    #: compact once the log holds this many entries (~a few hundred KB)
    _COMPACT_LINES = 2048

    def _dir_mtime(self, experiment: str) -> Optional[int]:
        try:
            return os.stat(self._tdir(experiment)).st_mtime_ns
        except OSError:
            return None

    def _stamp_dir(self, experiment: str, pre_mtime: Optional[int]) -> None:
        """Advance the heal stamp past OUR OWN doc write (under the flock).

        ``pre_mtime`` is the dir mtime the caller observed BEFORE writing.
        Only when it matches the recorded stamp may the new mtime be
        absorbed — otherwise a foreign un-indexed write landed in between
        and our own write must NOT launder it: the stamp is invalidated
        so the next read runs the full listdir heal.
        """
        if (pre_mtime is not None
                and pre_mtime == self._dir_stamp.get(experiment)):
            self._dir_stamp[experiment] = self._dir_mtime(experiment)
        else:
            self._dir_stamp[experiment] = None  # force the next heal

    def _ipath(self, experiment: str) -> str:
        return os.path.join(self._edir(experiment), "trials.index.json")

    def _lpath(self, experiment: str) -> str:
        return os.path.join(self._edir(experiment), "trials.index.log")

    def _tdir(self, experiment: str) -> str:
        return os.path.join(self._edir(experiment), "trials")

    def _rebuild_index(self, experiment: str) -> Dict[str, Any]:
        """Full scan → fresh index (fresh epoch: held cursors invalidate)."""
        tdir = self._tdir(experiment)
        statuses: Dict[str, str] = {}
        done: List[tuple] = []
        fresh: List[list] = []
        if os.path.isdir(tdir):
            for fn in os.listdir(tdir):
                if not fn.endswith(".json"):
                    continue
                doc = self._read_json(os.path.join(tdir, fn))
                if not doc:
                    continue
                statuses[doc["id"]] = doc.get("status", "new")
                if doc.get("status") == "completed":
                    done.append((doc.get("end_time") or 0, doc["id"]))
                elif doc.get("status") == "new":
                    fresh.append([doc.get("submit_time") or 0, doc["id"]])
        counts: Dict[str, int] = {}
        for s in statuses.values():
            counts[s] = counts.get(s, 0) + 1
        idx = {
            "epoch": uuid.uuid4().hex,
            "statuses": statuses,
            "counts": counts,
            "completed_log": [tid for _, tid in sorted(done)],
            "new_queue": sorted(fresh),
        }
        self._write_json(self._ipath(experiment), idx)
        try:  # the snapshot now covers everything the log said
            os.remove(self._lpath(experiment))
        except OSError:
            pass
        return idx

    @staticmethod
    def _idx_counts(idx: Dict[str, Any]) -> Dict[str, int]:
        """The index's per-status counts, derived once for a legacy
        snapshot that predates the ``counts`` key and maintained
        incrementally afterwards (see :meth:`_idx_status_set`) — this is
        what makes :meth:`count` O(1) instead of a scan over every
        trial's status each workon-cycle poll."""
        counts = idx.get("counts")
        if counts is None:
            counts = {}
            for s in idx["statuses"].values():
                counts[s] = counts.get(s, 0) + 1
            idx["counts"] = counts
        return counts

    @classmethod
    def _idx_status_set(cls, idx: Dict[str, Any], trial_id: str,
                        status: str) -> Optional[str]:
        """Single write point for ``idx["statuses"]`` so the incremental
        counts can never drift from the statuses map; returns the prior
        status."""
        counts = cls._idx_counts(idx)
        old = idx["statuses"].get(trial_id)
        if old == status:
            return old
        if old is not None:
            left = counts.get(old, 0) - 1
            if left > 0:
                counts[old] = left
            else:
                counts.pop(old, None)
        counts[status] = counts.get(status, 0) + 1
        idx["statuses"][trial_id] = status
        return old

    def _index_stamp(self, experiment: str):
        """(snapshot mtime+size, log size) — the cache key."""
        try:
            st = os.stat(self._ipath(experiment))
            snap = (st.st_mtime_ns, st.st_size)
        except OSError:
            snap = None
        try:
            log_size = os.stat(self._lpath(experiment)).st_size
        except OSError:
            log_size = 0
        return (snap, log_size)

    def _replay_log(self, experiment: str, idx: Dict[str, Any],
                    start: int, end: int) -> None:
        """Apply log bytes [start, end) to ``idx`` in place."""
        import bisect

        if end <= start:
            return
        with open(self._lpath(experiment), "rb") as f:
            f.seek(start)
            data = f.read(end - start)
        # a crash between compaction's snapshot write and log removal
        # replays records the snapshot already folded in; the seen-set
        # keeps completed_log free of duplicates in that window (cursor
        # consumers dedup by id anyway, per the LedgerBackend contract —
        # this just keeps the common path exactly-once)
        done = set(idx["completed_log"])
        for line in data.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn trailing write: doc authority re-checks
            tid, status = rec.get("t"), rec.get("s")
            if not tid or not status:
                continue
            self._idx_status_set(idx, tid, status)
            if status == "completed" and tid not in done:
                idx["completed_log"].append(tid)
                done.add(tid)
            elif status == "new":
                bisect.insort(
                    idx["new_queue"], [rec.get("st") or 0, tid]
                )

    def _load_index(self, experiment: str,
                    heal: bool = True) -> Dict[str, Any]:
        """Snapshot + log replay, rebuilt when missing or out of sync.

        Incremental: when the snapshot is unchanged and only the log grew
        since the cached parse, just the new log bytes replay — the
        common case for N processes racing one experiment. The sync check
        (``heal=True``, the READ paths) is a listdir LENGTH comparison —
        no document reads — catching registrations that bypassed the
        index. The WRITE path (:meth:`_index_set`) passes ``heal=False``:
        it runs right after this process's own document write, where a
        one-file delta is expected, not drift — healing there would mint
        a fresh epoch (cursor invalidation = full refetch) per register.
        """
        snap_stamp, log_size = self._index_stamp(experiment)
        cached = self._idx_cache.get(experiment)
        idx = None
        unchanged = False
        if cached is not None and snap_stamp is not None:
            c_snap, c_log, c_idx = cached
            if c_snap == snap_stamp and c_log == log_size:
                idx = c_idx
                unchanged = True
            elif c_snap == snap_stamp and c_log < log_size:
                self._replay_log(experiment, c_idx, c_log, log_size)
                idx = c_idx
        if idx is None and snap_stamp is not None:
            idx = self._read_json(self._ipath(experiment))
            if isinstance(idx, dict):
                idx.setdefault("new_queue", None)
                if idx["new_queue"] is None:  # pre-log snapshot on disk
                    idx = None
                else:
                    self._replay_log(experiment, idx, 0, log_size)
        broken = (not isinstance(idx, dict) or "statuses" not in idx
                  or "completed_log" not in idx)
        if not broken and heal:
            # the listdir count-check exists to catch a writer that
            # touches docs WITHOUT the index (pre-index era, foreign
            # tooling). Running it on every read made the heal itself
            # the top cost (O(n) dirents × ~6 reads/cycle). The trials
            # dir's mtime changes on any entry add/replace, and our own
            # writes record it under the flock — so an unchanged stamp
            # proves nothing foreign happened and the listdir can be
            # skipped; any foreign write is still caught on the very
            # next read (the contract test_index_self_heals pins)
            tdir = self._tdir(experiment)
            try:
                dir_now: Optional[int] = os.stat(tdir).st_mtime_ns
            except OSError:
                dir_now = None
            if (not unchanged or dir_now is None
                    or dir_now != self._dir_stamp.get(experiment)):
                n_files = (
                    sum(1 for fn in os.listdir(tdir)
                        if fn.endswith(".json"))
                    if os.path.isdir(tdir) else 0
                )
                broken = len(idx["statuses"]) != n_files
                self._dir_stamp[experiment] = dir_now
        if broken:
            idx = self._rebuild_index(experiment)
            snap_stamp, log_size = self._index_stamp(experiment)
        self._idx_cache[experiment] = (snap_stamp, log_size, idx)
        return idx

    def _index_set(self, experiment: str, trial_id: str, status: str,
                   submit_time: Optional[float] = None) -> None:
        import bisect

        idx = self._load_index(experiment, heal=False)
        old = self._idx_status_set(idx, trial_id, status)
        if status == "completed" and old != "completed":
            idx["completed_log"].append(trial_id)
        elif status == "new":
            bisect.insort(idx["new_queue"], [submit_time or 0, trial_id])
        rec: Dict[str, Any] = {"t": trial_id, "s": status}
        if status == "new":
            rec["st"] = submit_time or 0
        try:
            with open(self._lpath(experiment), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            # the trial DOC already committed; a stale on-disk index with
            # an unchanged file count would evade the listdir heal and
            # (for a final completion) never self-correct — drop the
            # index so the next read rebuilds from the documents
            self._idx_cache.pop(experiment, None)
            for path in (self._ipath(experiment), self._lpath(experiment)):
                try:
                    os.remove(path)
                except OSError:
                    pass
            return
        snap_stamp, log_size = self._index_stamp(experiment)
        # estimate entries from bytes? no — count lines only at compaction
        # check time, cheaply, via the growing size (~40-80 B per line)
        if log_size > self._COMPACT_LINES * 48:
            self._compact_locked(experiment, idx)
            snap_stamp, log_size = self._index_stamp(experiment)
        self._idx_cache[experiment] = (snap_stamp, log_size, idx)

    def _compact_locked(self, experiment: str, idx: Dict[str, Any]) -> int:
        """Fold the log into the snapshot (caller holds the flock).

        Prunes consumed queue entries, persists, removes the log; bytes
        reclaimed returned. SAME epoch: completed_log content is
        unchanged, so held fetch_completed_since cursors stay valid.
        """
        try:
            log_size = os.stat(self._lpath(experiment)).st_size
        except OSError:
            log_size = 0
        if log_size == 0:
            # nothing to fold: do NOT rewrite the snapshot — that would
            # bump its mtime and cache-bust every other process's parsed
            # index for zero reclaimed bytes
            return 0
        idx["new_queue"] = [
            e for e in idx["new_queue"]
            if idx["statuses"].get(e[1]) == "new"
        ]
        self._write_json(self._ipath(experiment), idx)
        try:
            os.remove(self._lpath(experiment))
        except OSError:
            # nothing was actually reclaimed — say so, and the surviving
            # log's replay is harmless (completed dedup in _replay_log;
            # duplicate queue entries drop lazily on reserve)
            return 0
        return log_size

    def register(self, trial: Trial) -> None:
        with self._locked(trial.experiment):
            path = self._tpath(trial.experiment, trial.id)
            if os.path.exists(path):
                raise DuplicateTrialError(trial.id)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pre = self._dir_mtime(trial.experiment)
            self._write_json(path, trial.to_dict())
            self._stamp_dir(trial.experiment, pre)
            self._index_set(trial.experiment, trial.id, trial.status,
                            submit_time=trial.submit_time)

    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        with self._locked(experiment):
            tdir = self._tdir(experiment)
            if not os.path.isdir(tdir):
                return None
            # the sorted new_queue narrows the candidate READ to one doc;
            # the documents stay the authority (re-checked below) — a
            # queue entry whose doc disagrees is simply dropped
            idx = self._load_index(experiment)
            queue = idx["new_queue"]
            while queue:
                _, tid = queue[0]
                if idx["statuses"].get(tid) != "new":
                    queue.pop(0)  # consumed/requeued under another entry
                    continue
                doc = self._read_json(self._tpath(experiment, tid))
                if not doc or doc.get("status") != "new":
                    queue.pop(0)
                    # doc drifted from index (old-version writer): heal
                    if doc is not None:
                        self._idx_status_set(
                            idx, tid, doc.get("status", "new"))
                    continue
                t = Trial.from_dict(doc)
                t.transition("reserved")
                t.worker = worker
                pre = self._dir_mtime(experiment)
                self._write_json(self._tpath(experiment, t.id), t.to_dict())
                self._stamp_dir(experiment, pre)
                queue.pop(0)
                self._index_set(experiment, t.id, "reserved")
                return t
            return None

    def update_trial(
        self,
        trial: Trial,
        expected_status: Optional[str] = None,
        expected_worker: Optional[str] = None,
    ) -> bool:
        with self._locked(trial.experiment):
            path = self._tpath(trial.experiment, trial.id)
            stored = self._read_json(path)
            if stored is None:
                return False
            if expected_status is not None and stored.get("status") != expected_status:
                return False
            if expected_worker is not None and stored.get("worker") != expected_worker:
                return False
            pre = self._dir_mtime(trial.experiment)
            self._write_json(path, trial.to_dict())
            self._stamp_dir(trial.experiment, pre)
            self._index_set(trial.experiment, trial.id, trial.status,
                            submit_time=trial.submit_time)
            return True

    def count(self, experiment: str, status=None) -> int:
        # O(1) off the index's incremental per-status counts (the workon
        # loop polls count() every cycle; scanning every trial's status
        # made that O(n²) over an experiment's life)
        statuses = (status,) if isinstance(status, str) else status
        with self._locked(experiment):
            if not os.path.isdir(self._edir(experiment)):
                return 0
            idx = self._load_index(experiment)
            if statuses is None:
                return len(idx["statuses"])
            counts = self._idx_counts(idx)
            return sum(counts.get(s, 0) for s in statuses)

    def fetch_completed_since(self, experiment: str, cursor=None):
        with self._locked(experiment):
            if not os.path.isdir(self._edir(experiment)):
                return [], None
            idx = self._load_index(experiment)
            log_ = idx["completed_log"]
            start = 0
            try:
                if cursor and cursor[0] == idx["epoch"] \
                        and int(cursor[1]) <= len(log_):
                    start = int(cursor[1])
            except (TypeError, ValueError, KeyError, IndexError):
                start = 0  # foreign cursor shape: full refetch
            out = []
            for tid in log_[start:]:
                doc = self._read_json(self._tpath(experiment, tid))
                if doc and doc.get("status") == "completed":
                    out.append(Trial.from_dict(doc))
            out.sort(key=lambda t: (t.submit_time or 0, t.id))
            return out, [idx["epoch"], len(log_)]

    def heartbeat(self, experiment: str, trial_id: str, worker: str) -> bool:
        with self._locked(experiment):
            path = self._tpath(experiment, trial_id)
            doc = self._read_json(path)
            if not doc or doc.get("status") != "reserved" or doc.get("worker") != worker:
                return False
            doc["heartbeat"] = self.clock.time()
            pre = self._dir_mtime(experiment)
            self._write_json(path, doc)
            self._stamp_dir(experiment, pre)
            return True

    def get(self, experiment: str, trial_id: str) -> Optional[Trial]:
        with self._locked(experiment):
            doc = self._read_json(self._tpath(experiment, trial_id))
            return Trial.from_dict(doc) if doc else None

    def compact(self, experiment: str) -> int:
        """Fold the index log into the snapshot; bytes reclaimed.

        Happens automatically past ``_COMPACT_LINES`` appends; the
        explicit path (``db compact``) exists for parked experiments
        whose log would otherwise sit at just-under-threshold forever.
        Epoch is preserved, so held observe cursors stay valid.
        """
        with self._locked(experiment):
            if not os.path.isdir(self._edir(experiment)):
                return 0
            idx = self._load_index(experiment)
            freed = self._compact_locked(experiment, idx)
            self._idx_cache[experiment] = (
                *self._index_stamp(experiment), idx
            )
        return freed

    def fetch(self, experiment: str, status=None) -> List[Trial]:
        statuses = (status,) if isinstance(status, str) else status
        with self._locked(experiment):
            tdir = self._tdir(experiment)
            out = []
            if not os.path.isdir(tdir):
                return out
            if statuses is None:
                candidates = (
                    os.path.join(tdir, fn) for fn in os.listdir(tdir)
                    if fn.endswith(".json")
                )
            else:
                # status-filtered fetches run EVERY workon cycle
                # (release_stale on 'reserved', the liar set_pending):
                # read only index-matching docs, not the whole table
                idx = self._load_index(experiment)
                candidates = (
                    self._tpath(experiment, tid)
                    for tid, st in idx["statuses"].items()
                    if st in statuses
                )
            for path in candidates:
                doc = self._read_json(path)
                if doc and (statuses is None
                            or doc.get("status") in statuses):
                    out.append(Trial.from_dict(doc))
            out.sort(key=lambda t: (t.submit_time or 0, t.id))
            return out


def ledger_from_spec(spec: str) -> LedgerBackend:
    """Build a backend from the user-facing spec string.

    ``"memory"`` | a bare directory path (native engine preferred, see
    :func:`local_ledger`) | ``"native:<dir>"`` | ``"file:<dir>"`` |
    ``"coord://host:port"`` — the same grammar the CLI's ``--ledger``
    accepts, shared here so the Python API (client.build_experiment)
    and the CLI can never diverge.
    """
    if spec == "memory":
        return make_ledger({"type": "memory"})
    if spec.startswith("coord://"):
        host, _, port = spec[len("coord://"):].partition(":")
        return make_ledger(
            {"type": "coord", "host": host, "port": int(port or 0)}
        )
    if spec.startswith("native:"):
        return make_ledger({"type": "native", "path": spec[len("native:"):]})
    if spec.startswith("file:"):
        return make_ledger({"type": "file", "path": spec[len("file:"):]})
    return local_ledger(spec)


def _has_python_file_store(path: str) -> bool:
    """True if ``path`` already holds file-backend experiments whose trials
    live as per-trial JSON documents and no native engine log: opening
    those with the engine would hide every existing trial from resume.

    The signal is an actual trial document, not a bare ``trials/`` dir —
    the native backend inherits FileLedger's create_experiment, which
    makes an (empty) ``trials/`` before the engine's ``store/`` exists; a
    doc-only experiment must keep resolving to native, or a crash between
    create and first register would silently flip the directory to the
    file backend while live native handles keep writing to the engine."""
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    for name in entries:
        edir = os.path.join(path, name)
        if not os.path.isfile(os.path.join(edir, "experiment.json")):
            continue
        if os.path.exists(os.path.join(edir, "store")):
            continue  # engine log present: native territory
        tdir = os.path.join(edir, "trials")
        try:
            has_doc = any(fn.endswith(".json") for fn in os.listdir(tdir))
        except OSError:
            has_doc = False
        if has_doc:
            return True
    return False


def local_ledger(path: str) -> LedgerBackend:
    """Backend for a bare local directory: native engine preferred.

    The C++ ledgerstore engine (:mod:`metaopt_tpu_torch.native`) runs
    the trial hot path in one appended record per op where the JSON file
    backend rewrites a document, so a bare path gets it by default, as
    in the reference. Falls back to
    the pure-Python file backend when (a) the directory already holds a
    file-backend store — its per-trial JSON documents are invisible to
    the engine and resume must keep working — or (b) the engine cannot
    compile/load here (no g++). Both fallbacks log the reason; the
    ``native:<dir>`` / ``file:<dir>`` spec prefixes pin a choice.
    """
    if _has_python_file_store(path):
        log.info(
            "ledger %s: existing file-backend store found; keeping the "
            "pure-Python file backend (migrate via 'db dump/load' "
            "into a 'native:' ledger for the fast engine)", path,
        )
        return make_ledger({"type": "file", "path": path})
    try:
        return make_ledger({"type": "native", "path": path})
    except Exception as exc:
        log.warning(
            "ledger %s: native engine unavailable (%s); falling back to "
            "the pure-Python file backend", path, exc,
        )
        return make_ledger({"type": "file", "path": path})


def make_ledger(config: Dict[str, Any]) -> LedgerBackend:
    """Build a backend from ``{"type": ..., **kwargs}`` (see ledger_registry)."""
    cfg = dict(config)
    kind = cfg.pop("type", "memory")
    if kind == "coord":  # lazy import to avoid a cycle
        from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient  # noqa: F401
    elif kind == "native":  # lazy: only compiles/loads the engine on use
        from metaopt_tpu_torch.ledger.native import NativeFileLedger  # noqa: F401
    return ledger_registry.get(kind)(**cfg)
