"""MTP003 clean fixture: the correct evict order, including a
prefix-abort path (early return after the publish) — aborting after a
prefix is LEGAL, every step is a crash barrier recovery tolerates — and
a wal-None guard, which the checker treats as always-journaling."""

import os

from metaopt_tpu.utils.fsjournal import fsync_dir


class Server:
    def evict(self, name, state, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(state)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)
        if not self._fenced(name):
            return False  # prefix abort: legal, the file is orphaned
        wal = self._wal
        if wal is not None:
            wal.append({"op": "evict", "experiment": name, "path": path})
            wal.sync(wal.appended_seq)
        self.inner.delete_experiment(name)
        return True
