"""Write-ahead log for the coordinator (port of ``metaopt_tpu/coord/wal.py``)
— the durability layer under
:class:`~metaopt_tpu_torch.coord.server.CoordServer`.

Every acknowledged mutation is on disk before its reply leaves the sender
thread, and recovery is ``restore(snapshot) + replay(WAL tail)``. The
record bytes equal the reference's, so either package replays the other's
log. ``extract_tail`` gives a hand-off one experiment's records.

Record formats (a log may mix them freely; each record declares its own)::

    v1:  {crc32:08x} {compact JSON}\\n
    v2:  "W2" {crc32 u32 BE} {len u32 BE} {binary body}

v1 is the original JSON-line record; v2 frames the wire format's binary
body (:func:`metaopt_tpu_torch.coord.protocol.encode_body`) with the crc32 over
the binary bytes. The two are unambiguous at any record boundary: a v1
line starts with 8 lowercase-hex characters and a space, a v2 record with
the two magic bytes ``W2`` followed by a binary header — so
:func:`read_records` dispatches per record and a pre-existing v1 log keeps
appending v2 records in place (replay of the mixed tail is exercised
bit-for-bit by the codec property tests). A record the binary codec cannot
carry falls back to a v1 line, so a "binary" log is always recoverable.

The crc covers the record body bytes; a torn tail (partial last batch
after a kill -9 or power cut) fails the crc or the parse and
:func:`read_records` physically truncates the file at the first bad record —
everything before it was group-commit fsynced and is intact by construction.
Each record carries a monotonic ``seq``; a snapshot embeds the highest
``seq`` it reflects (``wal_seq``), so replay applies only the tail and the
log is compacted down to that tail after every snapshot.

Group commit reuses the leader/latecomer window pattern of the server's
``_ProduceCoalescer``: the first thread that needs durability becomes the
leader, optionally sleeps ``group_window_s``, then writes + fsyncs EVERY
record appended so far in one batch; threads that arrive while the leader is
in fsync wait on the condition variable and are released together when the
batch lands. Under fan-in the fsync cost therefore amortizes across the same
burst of requests that already coalesces produce calls — with the default
``group_window_s=0`` the fsync duration itself is the batching window (while
one fsync runs, the next batch accumulates), which keeps single-client
latency unchanged.

Appends are buffer-only (one lock, no I/O) and may be called under the
server's per-experiment locks; ``sync()`` does the I/O and must be called
OUTSIDE them (the server calls it from each connection's sender thread).

No background threads: group commit runs on caller threads, so the module
adds nothing to the coordinator's thread census (tests assert no leaked
``coord-*`` threads per test).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from metaopt_tpu_torch.coord.protocol import (HAVE_WIRE_V2, ProtocolError,
                                              decode_body, encode_body)
from metaopt_tpu_torch.utils import fsjournal as fsj
# re-exported: server.py and the snapshot/evict publishers import it from
# here; the implementation lives in the FS seam so every directory fsync
# lands in a recorded effect trace under `crashcheck`
from metaopt_tpu_torch.utils.fsjournal import fsync_dir  # noqa: F401
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger(__name__)

_V2_MAGIC = b"W2"
_V2_HDR = struct.Struct(">2sII")  # magic, crc32(body), len(body)
# a single WAL record beyond this is a corrupt length field, not data —
# same ceiling as the wire's MAX_MSG_BYTES
_V2_MAX_BODY = 64 * 1024 * 1024


def _frame_v1(rec: Dict[str, Any]) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), default=str).encode()
    return b"%08x %s\n" % (zlib.crc32(payload), payload)


def _frame_v2(rec: Dict[str, Any]) -> bytes:
    try:
        # no default hook: a record msgpack can't carry natively (>64-bit
        # ints, stray objects) must take the v1 path wholesale so replay
        # yields exactly what a pure-v1 log would (json keeps big ints;
        # a msgpack default=str would silently stringify them)
        body = encode_body(rec)
    except ProtocolError:
        # per-record fallback: the log stays mixed rather than losing
        # the record or failing the append
        return _frame_v1(rec)
    return _V2_HDR.pack(_V2_MAGIC, zlib.crc32(body), len(body)) + body


# kept under the original name: tests and tooling frame v1 records with it
_frame = _frame_v1


def read_records(path: str, truncate_torn: bool = True
                 ) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a WAL file (v1 lines and v2 binary records, freely mixed);
    returns ``(records, torn_bytes)``.

    Stops at the first record whose crc or parse fails — the torn tail of
    a crash mid-batch — and (by default) truncates the file there so a
    later append never interleaves new records with torn garbage.
    ``torn_bytes`` is how many bytes were dropped (0 = clean log).
    """
    records: List[Dict[str, Any]] = []
    good_end = 0
    torn = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return records, 0
    pos = 0
    size = len(data)
    while pos < size:
        try:
            if data[pos:pos + 2] == _V2_MAGIC:
                # v2: fixed header + crc'd binary body (length-delimited,
                # so a body byte that happens to be 0x0a never splits it)
                if pos + _V2_HDR.size > size:
                    raise ValueError("torn v2 header")
                _, crc, length = _V2_HDR.unpack_from(data, pos)
                end = pos + _V2_HDR.size + length
                if length > _V2_MAX_BODY or end > size:
                    raise ValueError("torn v2 body")
                body = data[pos + _V2_HDR.size:end]
                if zlib.crc32(body) != crc:
                    raise ValueError("v2 crc mismatch")
                rec = decode_body(body)
                if not isinstance(rec, dict):
                    raise ValueError("v2 record is not a dict")
            else:
                nl = data.find(b"\n", pos)
                line = data[pos:nl] if nl != -1 else data[pos:]
                end = (nl + 1) if nl != -1 else size
                crc_hex, payload = line.split(b" ", 1)
                if int(crc_hex, 16) != zlib.crc32(payload):
                    raise ValueError("crc mismatch")
                rec = json.loads(payload)
        except (ValueError, json.JSONDecodeError, ProtocolError):
            torn = size - pos
            break
        records.append(rec)
        good_end = end
        pos = end
    if torn and truncate_torn:
        log.warning("WAL %s: torn tail (%d bytes after record %d) truncated",
                    path, torn, records[-1].get("seq", 0) if records else 0)
        fsj.truncate(path, good_end)
    return records, torn


def record_experiment(rec: Dict[str, Any]) -> Optional[str]:
    """Which experiment a WAL record belongs to, or ``None`` for global
    records (``shard_map`` adoption markers, unknown kinds).

    Hand-off ships exactly the records the destination needs to redo one
    experiment, so attribution must agree with how ``_apply_wal_record``
    reads each kind back: trial records via the embedded doc, experiment
    lifecycle ops via their name argument, reply records via the ``exp``
    tag stamped by ``_journal_reply``.
    """
    op = rec.get("op")
    if op == "put_trial":
        return (rec.get("trial") or {}).get("experiment")
    if op == "create_experiment":
        return (rec.get("config") or {}).get("name")
    if op in ("update_experiment", "delete_experiment"):
        return rec.get("name")
    if op == "set_signal":
        return rec.get("experiment")
    if op in ("evict", "hydrate"):
        # lazy eviction lifecycle (server._evict_fenced / hydrate): a
        # hand-off extracting an experiment's tail must carry these or
        # the destination replays trial records over a stale residency
        return rec.get("experiment")
    if op == "reply":
        return rec.get("exp")
    return None


class WriteAheadLog:
    """Append-buffered, group-commit-fsynced redo log.

    ``append(rec)`` is cheap (stamp a seq, frame, buffer) and safe under
    ledger locks; ``sync(target_seq)`` blocks until every record up to
    ``target_seq`` is fsynced, electing one caller as the batch leader.
    ``fsync=False`` keeps the write ordering but skips the fsync — for
    benchmarks isolating the syscall cost, never for production.

    ``binary`` selects the record framing for NEW records (default: v2
    binary when the codec is available). Replay always accepts both
    framings, so flipping it — or upgrading a server over an existing v1
    log — needs no migration: the log is simply mixed from that point on.
    """

    def __init__(self, path: str, fsync: bool = True,
                 group_window_s: float = 0.0,
                 binary: Optional[bool] = None,
                 clock: Optional[Clock] = None) -> None:
        self.path = path
        self.fsync = fsync
        self.group_window_s = group_window_s
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.binary = HAVE_WIRE_V2 if binary is None else (
            bool(binary) and HAVE_WIRE_V2)
        self._frame_rec = _frame_v2 if self.binary else _frame_v1
        self._buf_lock = threading.Lock()   # buffer + seq counter
        self._cv = threading.Condition()    # group-commit leader election
        self._pending: List[bytes] = []
        self._next_seq = 1
        self._appended = 0   # last seq handed out
        self._durable = 0    # last seq known fsynced
        self._syncing = False
        self._failed = False  # fsync/write failed: journaling degraded
        self._fence = 0      # open compaction fences (hand-off tail ships)
        #: per-thread share of ``_fence`` (thread id → open depth): lets
        #: ``compact`` distinguish its OWN caller's fence (snapshot wraps
        #: its compact in one to exclude concurrent extractions) from a
        #: foreign hand-off's — waiting on your own fence would deadlock
        self._fence_owners: Dict[int, int] = {}
        self._f: Optional[Any] = None
        self.batches = 0     # fsync batches written (amortization telemetry)
        self.records = 0

    # -- lifecycle --------------------------------------------------------
    def open(self, next_seq: int = 1) -> "WriteAheadLog":
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "ab")
        # single-threaded: open() runs before any serving thread exists
        self._next_seq = max(1, next_seq)  # mtpu: lint-ok MTL003 pre-serving
        self._appended = self._durable = (  # mtpu: lint-ok MTL003 pre-serving
            self._next_seq - 1)
        return self

    def close(self) -> None:
        with self._cv:
            while self._syncing:
                self._cv.wait(timeout=1.0)
            self._syncing = True
        try:
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            if self._f is not None:
                try:
                    self._write_batch(batch)
                    # publish under the cv like sync()/compact(): a racing
                    # sync() latecomer polls _durable under the cv, and an
                    # unfenced write here could leave it waiting a full
                    # timeout on a stale value
                    with self._cv:
                        self._durable = max(self._durable, upto)
                except OSError:
                    log.exception("WAL close flush failed")
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
        finally:
            with self._cv:
                self._syncing = False
                self._cv.notify_all()

    @property
    def appended_seq(self) -> int:
        with self._buf_lock:
            return self._appended

    @property
    def durable_seq(self) -> int:
        with self._cv:
            return self._durable

    # -- hot path ---------------------------------------------------------
    def append(self, rec: Dict[str, Any]) -> int:
        """Stamp + buffer one record; returns its seq. No I/O here —
        callers that need durability follow with ``sync(seq)`` outside any
        ledger lock."""
        if self._f is None or self._failed:
            return 0
        with self._buf_lock:
            seq = self._next_seq
            self._next_seq += 1
            rec["seq"] = seq
            self._pending.append(self._frame_rec(rec))
            self._appended = seq
        return seq

    def sync(self, target_seq: int) -> None:
        """Block until every record up to ``target_seq`` is fsynced.

        Leader/latecomer group commit: the first waiter becomes leader,
        optionally sleeps the window out, then writes + fsyncs the WHOLE
        pending buffer (including records appended by threads that arrived
        during the wait); latecomers block on the condition variable and
        are all released when the batch lands.
        """
        if target_seq <= 0 or self._f is None:
            return
        while True:
            with self._cv:
                if self._durable >= target_seq or self._failed:
                    return
                if self._syncing:
                    self._cv.wait(timeout=1.0)
                    continue
                self._syncing = True
            break
        # leader from here
        try:
            if self.group_window_s > 0:
                # let the burst pile in — same amortization window doctrine
                # as _ProduceCoalescer (0 = fsync-duration batching only)
                self.clock.sleep(self.group_window_s)
            # one batch per leader, then hand off: keeping the leader role
            # across batches was measured SLOWER at 32-worker fan-in (the
            # leader's own acked client idles while it writes strangers'
            # batches, draining the pipeline)
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            if batch:
                self._write_batch(batch)
            with self._cv:
                self._durable = max(self._durable, upto)
                self._cv.notify_all()
        except OSError:
            # durability is degraded, the service stays up: callers stop
            # waiting (and the server logs loudly) rather than deadlocking
            # every reply behind a dead disk
            log.exception("WAL write/fsync failed — durability degraded")
            # fence like _durable: latecomers poll _failed under the cv,
            # and an unfenced store could leave one waiting a full
            # timeout on a stale value
            with self._cv:
                self._failed = True
        finally:
            with self._cv:
                self._syncing = False
                self._cv.notify_all()

    def _write_batch(self, batch: List[bytes]) -> None:
        if not batch:
            return
        data = b"".join(batch)
        from metaopt_tpu_torch.executor.faults import faults

        if faults.fire("torn_wal_tail"):
            # chaos: die mid-batch — half the bytes land, then SIGKILL.
            # Recovery must truncate the torn half-record and keep
            # everything previously acknowledged.
            self._f.write(data[: max(1, len(data) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())
            os.kill(os.getpid(), signal.SIGKILL)
        fsj.append(self._f, self.path, data, fsync=self.fsync)
        # counters are read by stats()/bench from other threads; the
        # lock is taken AFTER the I/O so fsync never runs under it
        with self._buf_lock:
            self.batches += 1
            self.records += len(batch)

    # -- hand-off ---------------------------------------------------------
    def compaction_fence(self) -> "_CompactionFence":
        """Context manager that blocks :meth:`compact` for its duration.

        A hand-off extracts an experiment's tail with :meth:`extract_tail`
        and then keeps referring to those seqs until the ownership commit;
        a compaction sneaking in between would rewrite the file out from
        under the ship. ``compact()`` waits while any fence is open;
        appends and syncs are unaffected.
        """
        return _CompactionFence(self)

    def extract_tail(self, experiment: str) -> List[Dict[str, Any]]:
        """All on-disk + buffered records attributed to ``experiment``.

        Takes the group-commit leader role so the pending buffer is
        flushed first and no concurrent batch interleaves with the read —
        the returned tail is therefore complete up to every acknowledged
        write at the moment of the call. Call under a
        :meth:`compaction_fence` when the result must stay valid until an
        ownership commit.
        """
        if self._f is None:
            return []
        while True:
            with self._cv:
                if self._syncing:
                    self._cv.wait(timeout=1.0)
                    continue
                self._syncing = True
            break
        upto = 0
        try:
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            try:
                self._write_batch(batch)
            except OSError:
                log.exception("WAL extract_tail flush failed")
                with self._cv:
                    self._failed = True
                return []
            records, _ = read_records(self.path, truncate_torn=False)
            return [r for r in records
                    if record_experiment(r) == experiment]
        finally:
            with self._cv:
                if not self._failed:
                    self._durable = max(self._durable, upto)
                self._syncing = False
                self._cv.notify_all()

    def _fence_enter(self) -> None:
        tid = threading.get_ident()
        with self._cv:
            self._fence += 1
            self._fence_owners[tid] = self._fence_owners.get(tid, 0) + 1

    def _fence_exit(self) -> None:
        tid = threading.get_ident()
        with self._cv:
            self._fence = max(0, self._fence - 1)
            depth = self._fence_owners.get(tid, 0) - 1
            if depth > 0:
                self._fence_owners[tid] = depth
            else:
                self._fence_owners.pop(tid, None)
            self._cv.notify_all()

    def _foreign_fences(self) -> int:
        # mtpu: holds(_cv)
        return self._fence - self._fence_owners.get(threading.get_ident(), 0)

    def fence_held(self) -> bool:
        """True while the CALLING thread holds an open compaction fence —
        the assertion hook for paths required to run fenced."""
        with self._cv:
            return self._fence_owners.get(threading.get_ident(), 0) > 0

    # -- maintenance ------------------------------------------------------
    def compact(self, upto_seq: int) -> None:
        """Drop every record with ``seq <= upto_seq`` (they are reflected
        in the snapshot stamped ``wal_seq=upto_seq``); keep the tail.

        Takes the leader role so no concurrent batch writes interleave
        with the rewrite; appends keep buffering meanwhile and land in the
        fresh file on the next sync.
        """
        if self._f is None:
            return
        while True:
            with self._cv:
                # a hand-off fence holds compaction off entirely: the
                # shipped tail must stay on disk until ownership commits.
                # Only FOREIGN fences count — the snapshot path compacts
                # under its own fence (held against concurrent
                # extractions), which must not block itself.
                if self._syncing or self._foreign_fences() > 0:
                    self._cv.wait(timeout=1.0)
                    continue
                self._syncing = True
            break
        upto = 0
        try:
            # flush the buffer first so the rewrite sees every record
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            try:
                self._write_batch(batch)
            except OSError:
                log.exception("WAL compact flush failed")
                with self._cv:
                    self._failed = True
                return
            records, _ = read_records(self.path, truncate_torn=False)
            tail = [r for r in records if r.get("seq", 0) > upto_seq]
            tmp = self.path + ".tmp"
            # rewritten in the log's own framing: compaction after an
            # upgrade is what migrates a mixed v1/v2 log to pure v2.
            # tmp is written + fsynced BEFORE the rename publishes it
            # (crash-atomic doctrine — MTP001).
            fsj.write_file(tmp, b"".join(self._frame_rec(r) for r in tail))
            # the marker precedes the rename: from the next effect on, a
            # crash state may legitimately lack records <= upto_seq (the
            # certifier must excuse them one event EARLY, never late)
            fsj.mark("wal_compacted", upto=upto_seq)
            fsj.replace(tmp, self.path)
            fsync_dir(self.path)
            try:
                self._f.close()
            except OSError:
                pass
            self._f = open(self.path, "ab")
        except OSError:
            log.exception("WAL compaction failed (log kept as-is)")
        finally:
            with self._cv:
                if not self._failed:
                    self._durable = max(self._durable, upto)
                self._syncing = False
                self._cv.notify_all()


class _CompactionFence:
    """``with wal.compaction_fence():`` — holds :meth:`compact` off."""

    def __init__(self, wal: WriteAheadLog) -> None:
        self._wal = wal

    def __enter__(self) -> "_CompactionFence":
        self._wal._fence_enter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._wal._fence_exit()
