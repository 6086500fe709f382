"""Durable file operations for the coordinator (port of
``metaopt_tpu/utils/fsjournal.py``, trimmed to the calls that
``coord/server.py`` and ``coord/wal.py`` make).

Each primitive performs the real I/O: a write flushed and fsynced before
the rename that publishes it, an atomic rename, an append, a truncation
and the directory fsync that makes a rename or a creation durable itself.
The reference also notes every effect into an optional recording journal
that its crash-state checker replays; that journaling is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any


def write_file(path: str, data: bytes, fsync: bool = True) -> None:
    """Create/overwrite ``path`` with ``data``, flushed (and by default
    fsynced) — the write half of a crash-atomic publish."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def append(f: Any, path: str, data: bytes, fsync: bool = True) -> None:
    """Append ``data`` to the open handle ``f`` (logically ``path``),
    flushed and optionally fsynced — the WAL batch-write primitive."""
    f.write(data)
    f.flush()
    if fsync:
        os.fsync(f.fileno())


def replace(src: str, dst: str) -> None:
    """Atomic rename — the publish point of a crash-atomic write."""
    os.replace(src, dst)


def unlink(path: str) -> None:
    os.remove(path)


def truncate(path: str, size: int) -> None:
    """Physically cut ``path`` at ``size`` (the torn-tail repair)."""
    with open(path, "r+b") as f:
        f.truncate(size)
        f.flush()
        os.fsync(f.fileno())


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
