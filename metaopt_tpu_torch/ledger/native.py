"""NativeFileLedger — file ledger on the C++ ledgerstore engine.

Port of ``metaopt_tpu/ledger/native.py``. Same on-disk-coordination role
as :class:`FileLedger`, but the trial hot path — register, reserve CAS,
heartbeat, stale sweep — runs in the native engine (the port's own copy,
``metaopt_tpu_torch/native/ledgerstore.cpp``, built with ``g++`` into
``metaopt_tpu_torch/_build/``): an append-only record log with an
in-memory index, every op serialized by an exclusive flock with log-tail
replay. A heartbeat appends ~40 bytes instead of rewriting a JSON document,
and reserve scans an index instead of re-reading every trial file.

Division of authority: the engine owns (status, worker, heartbeat) — the
fields concurrency is fought over — while the full trial document rides
along as an opaque JSON payload. Reads overlay the engine's fields onto the
payload so a stale payload status can never win. Experiment documents are
low-rate and stay on the inherited FileLedger JSON path.

The store's format is the reference's byte for byte (the same engine
source, the same JSON payloads and experiment documents), so either
package's engine reads and writes the other's stores.

Falls back never: constructing this backend without a working toolchain
raises, and ``make_ledger({"type": "file"})`` keeps using the pure-Python
backend. A bare directory path prefers this backend
(:func:`~metaopt_tpu_torch.ledger.backends.local_ledger`);
``{"type": "native"}`` (CLI: ``--ledger native:<dir>``) pins it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.ledger.backends import (
    DuplicateExperimentError,
    DuplicateTrialError,
    FileLedger,
    ledger_registry,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.native import load_ledgerstore


def _safe(s: str) -> bytes:
    """Engine string fields must stay quote/backslash-free (envelope
    contract documented in ledgerstore.cpp). Reject, never strip: silently
    sanitizing could collide two distinct worker/trial identifiers and
    break the exactly-one-owner guarantee."""
    if '"' in s or "\\" in s:
        raise ValueError(
            f"ledger identifier {s!r} may not contain quotes or backslashes"
        )
    return s.encode()


@ledger_registry.register("native")
class NativeFileLedger(FileLedger):
    def __init__(self, path: Optional[str] = None, **kw: Any) -> None:
        super().__init__(path, **kw)
        self._lib = load_ledgerstore()
        if self._lib is None:
            raise RuntimeError(
                "native ledgerstore unavailable (no g++?); "
                "use the 'file' backend instead"
            )
        # (pid, experiment) → engine handle: a handle's flock fd must never
        # be shared across fork (both sides would believe they hold the lock)
        self._handles: Dict[tuple, int] = {}
        self._hlock = threading.Lock()

    # -- engine plumbing ---------------------------------------------------
    def _handle(self, experiment: str) -> tuple:
        """(handle, per-handle lock). flock is per open-file-description, so
        threads sharing a handle must also serialize in-process."""
        key = (os.getpid(), experiment)
        with self._hlock:
            ent = self._handles.get(key)
            if ent is None:
                sdir = os.path.join(self._edir(experiment), "store")
                os.makedirs(os.path.dirname(sdir), exist_ok=True)
                h = self._lib.ls_open(sdir.encode())
                if not h:
                    raise RuntimeError(f"ledgerstore open failed: {sdir}")
                ent = (h, threading.Lock())
                self._handles[key] = ent
            return ent

    def release_handle(self, experiment: str) -> None:
        """Close this process's engine handle for ``experiment``, if open.

        The eviction plane calls this when an idle experiment is moved
        to its snapshot file: the flock fd (and the engine's in-memory
        index) is the resident cost a native-backed ledger can actually
        shed. The next touch simply re-opens via ``_handle``.
        """
        key = (os.getpid(), experiment)
        with self._hlock:
            ent = self._handles.pop(key, None)
        if ent is not None:
            h, lk = ent
            with lk:
                self._lib.ls_close(h)

    def create_experiment(self, config: Dict[str, Any]) -> None:
        """FileLedger's create + an engine-ghost heal.

        A register racing a past ``delete_experiment`` can append an op-1
        put AFTER the wipe record (registers serialize on the engine
        flock, not the doc lock) — a new life of the name must not
        inherit it, so an existing engine store is wiped again before the
        doc is written (the file backend heals the same race for JSON
        ghost docs). Residual window: a ghost landing between this wipe
        and the doc write still survives — closing it needs per-life
        generation fencing inside the engine, which trades more format
        churn than the microsecond window justifies.
        """
        import shutil

        name = config["name"]
        with self._locked(name):
            epath = os.path.join(self._edir(name), "experiment.json")
            if os.path.exists(epath):
                raise DuplicateExperimentError(name)
            tdir = os.path.join(self._edir(name), "trials")
            if os.path.isdir(tdir):
                shutil.rmtree(tdir, ignore_errors=True)
            os.makedirs(tdir, exist_ok=True)
            if os.path.isdir(os.path.join(self._edir(name), "store")):
                h, hlock = self._handle(name)
                with hlock:
                    self._lib.ls_wipe(h)
            self._write_json(epath, config)

    def delete_experiment(self, name: str) -> bool:
        """Delete = engine WIPE record + removal of the JSON documents.

        The engine's lock file and log inode must survive (other processes
        hold open handles whose flock identity an unlink would silently
        fork — two writers, each believing it has the lock), so deletion is
        an APPENDED op-5 record: every handle replays it on its next locked
        op and drops all entries. Only the side documents (experiment.json,
        trials index, any stray per-trial JSON) are removed; the ``store/``
        directory stays, and a recreated experiment of the same name reuses
        the same engine log under the same lock. Mixed-version caveat: a
        pre-wipe build replaying the log ignores op 5 and still sees the
        old trials."""
        import shutil

        with self._locked(name):
            epath = os.path.join(self._edir(name), "experiment.json")
            if not os.path.exists(epath):
                return False
            h, hlock = self._handle(name)
            with hlock:
                if self._lib.ls_wipe(h) != 0:
                    raise RuntimeError(f"ledgerstore wipe failed: {name}")
            os.remove(epath)
            for side in ("trials.index.json",):
                try:
                    os.remove(os.path.join(self._edir(name), side))
                except OSError:
                    pass
            shutil.rmtree(os.path.join(self._edir(name), "trials"),
                          ignore_errors=True)
            self._idx_cache.pop(name, None)
        return True

    def _take(self, ptr) -> str:
        """Copy + free a malloc'd engine string."""
        if not ptr:
            return ""
        try:
            import ctypes

            return ctypes.string_at(ptr).decode()
        finally:
            self._lib.ls_free(ptr)

    @staticmethod
    def _status_csv(status) -> bytes:
        if status is None:
            return b""
        if isinstance(status, str):
            return status.encode()
        return ",".join(status).encode()

    @staticmethod
    def _from_envelope(env: Dict[str, Any]) -> Trial:
        """Trial from payload with the engine's authoritative overlay."""
        doc = env["payload"] or {}
        doc["status"] = env["status"]
        hb = env["heartbeat"]
        doc["heartbeat"] = hb if hb > 0 else None
        if env["status"] == "reserved":
            doc["worker"] = env["worker"] or None
        # trusted: the payload is this backend's own ls_put serialization
        # of a to_dict — skipping __post_init__ avoids re-jsonable'ing
        # params on EVERY envelope decode (fetch of 10k trials pays it
        # 10k times) and cannot re-mint ids or mis-validate
        return Trial.from_dict_trusted(doc)

    # -- trial ops on the engine ------------------------------------------
    def register(self, trial: Trial) -> None:
        h, lk = self._handle(trial.experiment)
        payload = json.dumps(trial.to_dict()).encode()
        with lk:
            rc = self._lib.ls_put(
                h, _safe(trial.id), _safe(trial.status), payload,
                float(trial.submit_time or 0.0),
            )
            cas_rc = 0
            if rc == 0 and (trial.worker or trial.heartbeat):
                # a restore may register an already-reserved trial:
                # its ownership record (worker + heartbeat) must survive into
                # the engine or the owner's next heartbeat fails and the
                # stale sweep double-executes the trial
                cas_rc = self._lib.ls_cas(
                    h, _safe(trial.id), b"", b"", _safe(trial.status),
                    _safe(trial.worker or ""), b"",
                    float(trial.heartbeat or 0.0),
                )
        if rc == 1:
            raise DuplicateTrialError(trial.id)
        if rc != 0:
            raise RuntimeError(f"ledgerstore put failed ({rc})")
        if cas_rc != 0:
            raise RuntimeError(
                f"ledgerstore ownership record failed ({cas_rc}) for {trial.id}"
            )

    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        h, lk = self._handle(experiment)
        with lk:
            raw = self._take(self._lib.ls_reserve(h, _safe(worker)))
        if not raw:
            return None
        t = self._from_envelope(json.loads(raw))
        t.worker = worker
        t.start_time = t.heartbeat
        return t

    def update_trial(
        self,
        trial: Trial,
        expected_status: Optional[str] = None,
        expected_worker: Optional[str] = None,
    ) -> bool:
        h, lk = self._handle(trial.experiment)
        payload = json.dumps(trial.to_dict()).encode()
        with lk:
            rc = self._lib.ls_cas(
                h,
                _safe(trial.id),
                _safe(expected_status or ""),
                _safe(expected_worker or ""),
                _safe(trial.status),
                _safe(trial.worker or ""),
                payload,
                float(trial.heartbeat or 0.0),
            )
        return rc == 0

    def heartbeat(self, experiment: str, trial_id: str, worker: str) -> bool:
        h, lk = self._handle(experiment)
        with lk:
            return self._lib.ls_heartbeat(h, _safe(trial_id), _safe(worker)) == 0

    def get(self, experiment: str, trial_id: str) -> Optional[Trial]:
        h, lk = self._handle(experiment)
        with lk:
            raw = self._take(self._lib.ls_get(h, _safe(trial_id)))
        return self._from_envelope(json.loads(raw)) if raw else None

    def fetch(self, experiment: str, status=None) -> List[Trial]:
        h, lk = self._handle(experiment)
        with lk:
            raw = self._take(self._lib.ls_fetch(h, self._status_csv(status)))
        out = [
            self._from_envelope(json.loads(line))
            for line in raw.splitlines()
            if line
        ]
        out.sort(key=lambda t: (t.submit_time or 0, t.id))
        return out

    def count(self, experiment: str, status=None) -> int:
        h, lk = self._handle(experiment)
        with lk:
            return int(self._lib.ls_count(h, self._status_csv(status)))

    def fetch_completed_since(self, experiment: str, cursor=None):
        """Incremental completed-fetch off the engine's log clock.

        The Producer calls this every produce cycle; the full ``fetch``
        deserializes EVERY completed trial each time — O(n²) JSON decode
        across an experiment. The engine's per-entry last-applied-record seq makes the
        delta exact across processes; a compaction (new log inode = new
        epoch) invalidates cursors and costs one full refetch, which the
        algorithms' observe-dedup absorbs.
        """
        try:
            epoch, seq = cursor or (0, 0)
            epoch, seq = int(epoch), int(seq)
        except (TypeError, ValueError):
            # a foreign-shape cursor (another backend's, a stale persisted
            # one) must DEGRADE to a full refetch, never kill the produce
            # cycle — the base-class contract
            epoch, seq = 0, 0
        h, lk = self._handle(experiment)
        with lk:
            raw = self._take(self._lib.ls_fetch_since(
                h, b"completed", epoch, seq
            ))
        lines = raw.splitlines()
        if not lines or not lines[0].startswith("C "):
            return self.fetch(experiment, "completed"), None
        _, new_epoch, new_seq = lines[0].split()
        out = [
            self._from_envelope(json.loads(line))
            for line in lines[1:]
            if line
        ]
        out.sort(key=lambda t: (t.submit_time or 0, t.id))
        return out, (int(new_epoch), int(new_seq))

    def compact(self, experiment: str) -> int:
        """Rewrite the experiment's log to its live state; bytes reclaimed.

        Heartbeat records (~40 bytes each, one per reservation refresh)
        and superseded document versions otherwise accumulate forever.
        Safe with live workers: the rewrite happens under the same flock
        every op takes, and other processes detect the replaced inode and
        rebuild from the fresh file.
        """
        h, lk = self._handle(experiment)
        with lk:
            freed = int(self._lib.ls_compact(h))
        if freed < 0:
            raise OSError(f"ledgerstore compaction failed for {experiment}")
        return freed

    def release_stale(self, experiment: str, timeout_s: float) -> List[Trial]:
        h, lk = self._handle(experiment)
        with lk:
            raw = self._take(self._lib.ls_release_stale(h, float(timeout_s)))
        out = []
        for line in raw.splitlines():
            if not line:
                continue
            t = self._from_envelope(json.loads(line))
            t.worker = None
            t.start_time = None
            out.append(t)
        return out
