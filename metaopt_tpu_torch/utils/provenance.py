"""Provenance stamps for benchmark artifacts.

Port of ``metaopt_tpu/utils/provenance.py``. Every perf row must
self-describe (commit, timestamp, backend), so that two rows far apart
can be told to straddle a change of code or not. One helper for every
emitter, so the stamp format can never drift between them. The port's
callers pass ``backend="cuda"`` and the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) as
``card=...``.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Any, Dict, Optional


def git_commit(repo: Optional[str] = None) -> str:
    """Short commit hash of the repo containing this file ("unknown" if not
    a checkout — artifacts must still be writable from an installed copy)."""
    repo = repo or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        )
        head = out.stdout.strip()
        if not head:
            return "unknown"
        # numbers from uncommitted code must not be attributed to HEAD —
        # same-hash rows with different perf would be an undetectable
        # straddle. Untracked files are excluded: a run's own logs and
        # artifacts are untracked while it runs, and counting them would
        # stamp every clean-checkout capture +dirty — modified TRACKED code
        # is what misattributes numbers
        dirty = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain",
             "--untracked-files=no"],
            capture_output=True, text=True, timeout=10,
        )
        return head + "+dirty" if dirty.stdout.strip() else head
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def provenance(backend: Optional[str] = None, **extra: Any) -> Dict[str, Any]:
    """The stamp dict to merge into a benchmark row at write time.

    ``extra`` fields ride along verbatim (e.g. the ``card`` a row was
    measured on, or a ``run`` id grouping the rows of one sweep attempt).
    """
    stamp: Dict[str, Any] = {
        "commit": git_commit(),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if backend is not None:
        stamp["backend"] = backend
    stamp.update(extra)
    return stamp
