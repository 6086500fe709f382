"""Lint fixture: blocking I/O and sleeps under a no-block buffer lock.

``flush_holding_lock`` fsyncs under ``_buf_lock`` (direct hit);
``nap_holding_lock`` sleeps under it; ``indirect`` reaches the fsync
through a helper, exercising the transitive summary.
"""

import os
import threading
import time


class Journal:
    def __init__(self, f):
        self._buf_lock = threading.Lock()
        self._f = f

    def flush_holding_lock(self):
        with self._buf_lock:
            os.fsync(self._f.fileno())

    def nap_holding_lock(self):
        with self._buf_lock:
            time.sleep(0.01)

    def _do_fsync(self):
        os.fsync(self._f.fileno())

    def indirect(self):
        with self._buf_lock:
            self._do_fsync()
