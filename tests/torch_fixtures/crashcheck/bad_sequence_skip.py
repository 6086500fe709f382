"""MTP003 skip fixture: a branch that jumps straight from the publish to
the drop, skipping the journal steps entirely on one path. MTP003 must
flag the skipping PATH even though another path through the same
function performs every step in order."""

import os

from metaopt_tpu.utils.fsjournal import fsync_dir


class Server:
    def evict(self, name, state, path, fast):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(state)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)
        if not fast:
            wal = self._wal
            if wal is not None:
                wal.append({"op": "evict", "experiment": name,
                            "path": path})
                wal.sync(wal.appended_seq)
        self.inner.delete_experiment(name)  # BUG on the fast path
