"""Fix-reverted MTP003 fixture: an evict that DROPS the resident state
before the evict record is journaled — the record-after-drop reorder. A
crash between the drop and the append leaves no journal pointing at the
evict file, so recovery forgets the experiment ever had state. The
registry entry for this fixture lives in the test (CrashConfig
override), mirroring protocol.DURABLE_SEQUENCES' "evict" entry."""

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
        self.inner.delete_experiment(name)  # BUG: drop before journal
        wal = self._wal
        if wal is not None:
            wal.append({"op": "evict", "experiment": name, "path": path})
            wal.sync(wal.appended_seq)
