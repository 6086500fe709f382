"""Child processes under a deadline (no torch import here).

Port of ``metaopt_tpu/utils/procs.py``, trimmed to :func:`run_with_deadline`
and the device probe the subprocess executor's circuit breaker runs,
:func:`cuda_backend_reachable` (the counterpart of the reference's
``tpu_backend_reachable``); plus :func:`process_age_s`, which the example
trial scripts report their start-up cost with. A probe child that hangs in CUDA runtime or context
initialization must not hang its parent, so children run Popen + poll +
kill — never ``subprocess.run(timeout=...)``, whose post-timeout cleanup
waits on the child — with their output sent to /dev/null.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional, Sequence


def run_with_deadline(argv: Sequence[str], timeout_s: float,
                      poll_s: float = 0.5) -> Optional[int]:
    """Run ``argv``; return its exit code, or None when the deadline hit and
    the child was killed (possibly unreapably — the reap is best-effort)."""
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        rc = proc.poll()
        if rc is not None:
            return rc
        time.sleep(poll_s)
    rc = proc.poll()  # the child may have exited during the last sleep
    if rc is None:
        proc.kill()
        try:  # non-blocking reap; a wedged child may be unwaitable
            proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            pass
    return rc


#: the probe child's program: a CUDA context, one kernel, one readback
CUDA_PROBE = "import torch; torch.zeros(1, device='cuda').sum().item()"


def cuda_backend_reachable(timeout_s: float = 90.0) -> bool:
    """Can a fresh interpreter reach a CUDA card right now?

    Probed in a disposable child, so a CUDA runtime or context that hangs costs
    this process ``timeout_s`` at most. False when ``CUDA_VISIBLE_DEVICES``
    is set and empty (no card is meant to be visible).
    """
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and not visible.strip():
        return False
    return run_with_deadline([sys.executable, "-c", CUDA_PROBE], timeout_s=timeout_s,
                             poll_s=0.2) == 0


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's start stamp
    (``/proc/self/stat`` field 22, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        # the command name (field 2) may hold spaces: split after its ')'
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
