"""Fix-reverted MTP001 fixture: the ``mtpu db dump`` archive publish as
it stood before its fix — staged write with no fsync, rename with no
directory fsync. A crash can publish a rename that points at data blocks
the disk never received, or lose the rename itself. The checker must
report BOTH halves (``nofsync`` and ``nodirfsync``) deterministically."""

import json
import os


def dump_archive(archive, output):
    text = json.dumps(archive, indent=2)
    tmp = output + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, output)  # atomic, but NOT durable: the revert
    return output
