"""Ledger backends: the storage/concurrency contract behind experiments.

Port of ``metaopt_tpu/ledger/backends.py``, trimmed to the in-memory and
the file backends. The contract kept:

- **register is create-if-absent** (duplicate id → ``DuplicateTrialError``,
  the CAS-failure signal Producer uses to drop lost suggestion races),
- **reserve is an atomic status CAS** ``new → reserved`` — exactly one worker
  wins a trial,
- **update_trial supports compare-and-swap on status** so a worker that lost
  its reservation (e.g. declared stale and re-issued) cannot clobber state.

The reference's ``MemoryLedger`` seals completed trials into a columnar
archive; here completed trials stay resident. :class:`FileLedger` keeps the
reference's on-disk layout exactly, so either package reads the other's
file ledgers. The native engine and the coordinator backend are not
ported yet: their specs raise.
"""

from __future__ import annotations

import fcntl
import heapq
import json
import logging
import os
import threading
import urllib.parse
import uuid
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from metaopt_tpu_torch.utils.registry import Registry

log = logging.getLogger(__name__)

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
        os.replace(tmp, path)

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

    ``"memory"`` | ``"file:<dir>"`` | a bare directory path (see
    :func:`local_ledger`) — the grammar the CLI's ``--ledger`` accepts.
    ``"native:<dir>"`` and ``"coord://host:port"`` raise: those backends
    are not ported yet.
    """
    if spec == "memory":
        return make_ledger({"type": "memory"})
    if spec.startswith("coord://"):
        return make_ledger({"type": "coord"})
    if spec.startswith("native:"):
        return make_ledger({"type": "native"})
    if spec.startswith("file:"):
        return make_ledger({"type": "file", "path": spec[len("file:"):]})
    return local_ledger(spec)


def _has_native_store(path: str) -> bool:
    """True if ``path`` holds an experiment written by the reference's
    native engine (an experiment dir with a ``store/`` log)."""
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    return any(
        os.path.isfile(os.path.join(path, name, "experiment.json"))
        and os.path.exists(os.path.join(path, name, "store"))
        for name in entries
    )


def local_ledger(path: str) -> LedgerBackend:
    """Backend for a bare local directory: the file backend.

    The reference prefers its native engine for a bare path and falls back
    to the file backend where the engine cannot load; the engine is not
    ported, so the port always takes that fallback. A directory that
    already holds a native store raises: the file backend cannot see the
    engine's trials, and resuming there would hide them.
    """
    if _has_native_store(path):
        raise RuntimeError(
            f"ledger {path}: holds a native-engine store, which the port "
            "cannot read (the native engine is not ported yet); pass "
            "'file:<dir>' for a separate file ledger"
        )
    log.info("ledger %s: the native engine is not ported; using the file "
             "backend", path)
    return make_ledger({"type": "file", "path": path})


def make_ledger(config: Dict[str, Any]) -> LedgerBackend:
    """Build a backend from ``{"type": ..., **kwargs}`` (see ledger_registry)."""
    cfg = dict(config)
    kind = cfg.pop("type", "memory")
    if kind in ("native", "coord"):
        raise NotImplementedError(
            f"the {kind!r} ledger backend is not ported yet (ROADMAP.md); "
            "use 'memory' or 'file:<dir>'"
        )
    return ledger_registry.get(kind)(**cfg)
