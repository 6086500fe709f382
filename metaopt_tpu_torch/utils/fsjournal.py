"""Injectable filesystem seam for the coordinator's durable paths (port
of ``metaopt_tpu/utils/fsjournal.py``; the same effects, journal and
crash-state enumeration).

Every crash-atomic file protocol in the repo (WAL group commit, snapshot
manifests, archive segment seal, evict files) performs the same handful
of primitive effects: write bytes, flush+fsync, atomic rename, directory
fsync, unlink, truncate. This module is the single choke point those
paths call instead of raw ``open``/``os.*`` — by default a pure
passthrough (one ``is None`` check per effect, no allocation), and under
``crashcheck`` a :class:`RecordingJournal` that captures the linear
effect trace of a real run, byte payloads included.

The recorded trace is what makes crash-state enumeration *exhaustive*
rather than sampled: :func:`enumerate_crash_states` yields every prefix
of the trace plus torn tails of the write the crash interrupted, and
:func:`materialize` turns any such state into real files in a scratch
directory so real recovery code (``read_records``,
``recover_shard_state``) can be run against it.

Crash model (the enumeration bound, the same as the reference's):
effects persist in program order and a crash preserves every completed
effect — the legal crash states are therefore the trace prefixes, plus,
for a crash *during* a write, every byte-level cut of that write's
payload. fsync/dir-fsync events are ordering markers in this model (a
prefix is durable by construction); the reordering-of-unflushed-pages
failure class is covered instead by the *static* MTP001 check, which
requires the fsync to exist before the rename on every path.

Logical markers (:func:`mark`) interleave acknowledgement points into
the trace — ``wal.sync`` marks the seqs it made durable, suites mark the
client-visible acks — which is what lets the certifier state "zero
acked-write loss" per crash state instead of per run.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple


class RecordingJournal:
    """Captures the effect trace of durable-path runs under ``root``.

    Effects on paths outside ``root`` are ignored — a suite records only
    its own scratch tree, never the test runner's unrelated I/O. Thread
    safe: the coordinator's sender/housekeeping threads append
    concurrently.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def _rel(self, path: str) -> Optional[str]:
        p = os.path.abspath(path)
        if p == self.root or p.startswith(self.root + os.sep):
            return os.path.relpath(p, self.root)
        return None

    def note(self, kind: str, path: Optional[str] = None,
             **meta: Any) -> None:
        if path is not None:
            rel = self._rel(path)
            if rel is None:
                return
            meta["path"] = rel
        with self._lock:
            self.events.append({"kind": kind, **meta})

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.events)


#: the active journal; ``None`` = passthrough (production default)
_active: Optional[RecordingJournal] = None


def installed() -> Optional[RecordingJournal]:
    return _active


@contextmanager
def recording(root: str) -> Iterator[RecordingJournal]:
    """Install a :class:`RecordingJournal` rooted at ``root`` for the
    duration of the block. Not reentrant — one recording at a time."""
    global _active
    prev, _active = _active, RecordingJournal(root)
    try:
        yield _active
    finally:
        _active = prev


def _note(kind: str, path: Optional[str] = None, **meta: Any) -> None:
    j = _active
    if j is not None:
        j.note(kind, path, **meta)


# -- primitive effects (real I/O + notify) --------------------------------

def write_file(path: str, data: bytes, fsync: bool = True) -> None:
    """Create/overwrite ``path`` with ``data``, flushed (and by default
    fsynced) — the write half of a crash-atomic publish."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    _note("write", path, data=data)
    if fsync:
        _note("fsync", path)


def append(f: Any, path: str, data: bytes, fsync: bool = True) -> None:
    """Append ``data`` to the open handle ``f`` (logically ``path``),
    flushed and optionally fsynced — the WAL batch-write primitive."""
    f.write(data)
    f.flush()
    if fsync:
        os.fsync(f.fileno())
    _note("append", path, data=data)
    if fsync:
        _note("fsync", path)


def replace(src: str, dst: str) -> None:
    """Atomic rename — the publish point of a crash-atomic write."""
    os.replace(src, dst)
    _note("replace", dst, src=os.path.basename(src))


def unlink(path: str) -> None:
    os.remove(path)
    _note("unlink", path)


def truncate(path: str, size: int) -> None:
    """Physically cut ``path`` at ``size`` (the torn-tail repair)."""
    with open(path, "r+b") as f:
        f.truncate(size)
        f.flush()
        os.fsync(f.fileno())
    _note("truncate", path, size=size)
    _note("fsync", path)


def fsync_dir(path: str) -> None:
    """fsync the parent directory so a rename/creat is itself durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _note("dir_fsync", path)


def mark(label: str, **meta: Any) -> None:
    """Interleave a logical marker (an ack point, a compaction bound)
    into the trace. Pure no-op unless a journal is recording."""
    _note("mark", None, label=label, **meta)


# -- crash-state enumeration ----------------------------------------------

#: effect kinds that change on-disk bytes (a crash mid-effect can tear
#: exactly these; everything else is instantaneous-or-absent)
_WRITE_KINDS = ("write", "append")


def materialize(events: List[Dict[str, Any]], upto: int,
                cut: Optional[int] = None) -> Dict[str, bytes]:
    """The on-disk tree (relpath → bytes) after the first ``upto``
    effects, optionally plus the first ``cut`` bytes of effect ``upto``
    (which must then be a write/append — the torn tail)."""
    files: Dict[str, bytes] = {}
    for e in events[:upto]:
        _apply(files, e, None)
    if cut is not None:
        _apply(files, events[upto], cut)
    return files


def _apply(files: Dict[str, bytes], e: Dict[str, Any],
           cut: Optional[int]) -> None:
    kind = e["kind"]
    if kind == "write":
        data = e["data"]
        files[e["path"]] = data if cut is None else data[:cut]
    elif kind == "append":
        data = e["data"]
        files[e["path"]] = files.get(e["path"], b"") + (
            data if cut is None else data[:cut])
    elif kind == "replace":
        src = os.path.join(os.path.dirname(e["path"]), e["src"])
        if src in files:
            files[e["path"]] = files.pop(src)
    elif kind == "unlink":
        files.pop(e["path"], None)
    elif kind == "truncate":
        if e["path"] in files:
            files[e["path"]] = files[e["path"]][:e["size"]]
    # fsync / dir_fsync / mark: ordering markers, no byte effect


def write_tree(files: Dict[str, bytes], dest: str) -> None:
    """Write a materialized crash state into real files under ``dest``."""
    for rel, data in files.items():
        full = os.path.join(dest, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)


def enumerate_crash_states(
    events: List[Dict[str, Any]],
    torn_cuts: Optional[int] = 3,
) -> Iterator[Tuple[str, int, Dict[str, bytes]]]:
    """Every legal crash state of a trace: ``(label, upto, files)``.

    For each prefix length ``upto`` the base state is yielded; when the
    *next* effect is a write/append, its torn variants follow —
    ``torn_cuts=None`` enumerates EVERY byte-level cut (the WAL suite's
    exhaustive mode), an integer caps it at that many representative
    cuts (1 byte, interior points, len-1).
    """
    for upto in range(len(events) + 1):
        yield f"@{upto}", upto, materialize(events, upto)
        if upto < len(events) and events[upto]["kind"] in _WRITE_KINDS:
            n = len(events[upto]["data"])
            if n <= 1:
                continue
            if torn_cuts is None:
                cuts = range(1, n)
            else:
                step = max(1, n // (torn_cuts + 1))
                cuts = sorted({1, n - 1, *range(step, n, step)} - {0, n})
            for c in cuts:
                yield (f"@{upto}+{c}b", upto,
                       materialize(events, upto, cut=c))
