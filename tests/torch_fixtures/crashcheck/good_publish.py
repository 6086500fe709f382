"""MTP001 clean fixtures: the full crash-atomic publish doctrine, once
spelled out raw and once through the fsjournal seam, plus a split
variant where the fsync halves live in local helpers (the call-summary
path: the checker must see through one level of indirection)."""

import json
import os

from metaopt_tpu.utils import fsjournal as fsj
from metaopt_tpu.utils.fsjournal import fsync_dir


def dump_archive(archive, output):
    text = json.dumps(archive, indent=2)
    tmp = output + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, output)
    fsync_dir(output)
    return output


def dump_archive_seam(archive, output):
    tmp = output + ".tmp"
    fsj.write_file(tmp, json.dumps(archive).encode())
    fsj.replace(tmp, output)
    fsync_dir(output)
    return output


class Publisher:
    def _stage(self, tmp, payload):
        fsj.write_file(tmp, payload)

    def _seal(self, path):
        fsync_dir(path)

    def publish(self, path, payload):
        tmp = path + ".tmp"
        self._stage(tmp, payload)
        os.replace(tmp, path)
        self._seal(path)
