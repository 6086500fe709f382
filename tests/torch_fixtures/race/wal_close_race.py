"""Seeded-bug fixture: the WAL ``close()`` durability-publish race.

This is a trimmed copy of :class:`metaopt_tpu.coord.wal.WriteAheadLog`
with its fix REVERTED: ``close()`` publishes ``_durable`` OUTSIDE
``self._cv`` while ``durable_seq``/``sync()`` latecomers read it under
the cv — unordered accesses with disjoint locksets, i.e. exactly the
MTR101 shape ``race`` exists to rediscover. The I/O is replaced by
an in-memory ``committed`` list (the race lives in the bookkeeping, not
the syscalls), and a ``before_publish`` test gate parks the closer right
inside the race window so the rediscovery test is deterministic in
schedule, not just in shape.

Never imported by the package — only by ``test_race_detector.py``.
"""

import threading
from typing import Any, Callable, Dict, List, Optional


class RacyWriteAheadLog:
    def __init__(self) -> None:
        self._buf_lock = threading.Lock()   # buffer + seq counter
        self._cv = threading.Condition()    # group-commit leader election
        self._pending: List[bytes] = []
        self._next_seq = 1
        self._appended = 0   # last seq handed out
        self._durable = 0    # last seq known committed
        self._syncing = False
        self.committed: List[bytes] = []
        #: test gate, invoked right before close() publishes durability
        self.before_publish: Optional[Callable[[], None]] = None

    def append(self, rec: Dict[str, Any]) -> int:
        with self._buf_lock:
            seq = self._next_seq
            self._next_seq += 1
            rec["seq"] = seq
            self._pending.append(repr(rec).encode())
            self._appended = seq
        return seq

    def sync(self, target_seq: int) -> None:
        while True:
            with self._cv:
                if self._durable >= target_seq:
                    return
                if self._syncing:
                    self._cv.wait(timeout=1.0)
                    continue
                self._syncing = True
            break
        try:
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            self.committed.extend(batch)
            with self._cv:
                self._durable = max(self._durable, upto)
                self._cv.notify_all()
        finally:
            with self._cv:
                self._syncing = False
                self._cv.notify_all()

    @property
    def durable_seq(self) -> int:
        with self._cv:
            return self._durable

    def close(self) -> None:
        with self._cv:
            while self._syncing:
                self._cv.wait(timeout=1.0)
            self._syncing = True
        try:
            with self._buf_lock:
                batch, self._pending = self._pending, []
                upto = self._appended
            self.committed.extend(batch)
            gate = self.before_publish
            if gate is not None:
                gate()
            # BUG (the fix reverted): the durability publish is not
            # fenced under self._cv, so a concurrent durable_seq/sync()
            # latecomer reads _durable with no ordering edge to this store
            self._durable = max(self._durable, upto)
        finally:
            with self._cv:
                self._syncing = False
                self._cv.notify_all()
