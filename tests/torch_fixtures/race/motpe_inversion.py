"""Seeded-bug fixture: the MOTPE ``state_dict`` lock-order inversion.

Miniature of a past AB-BA: the TPE base class orders its locks
``_launch_lock`` -> ``_kernel_lock`` on every suggest path, while the
MOTPE subclass's ``state_dict`` override grabbed ``_kernel_lock`` FIRST
and then called ``super().state_dict()`` (which takes ``_launch_lock``)
— the reverse order, a deadlock waiting for the right interleaving.
The static checker caught the original via the class hierarchy; this
copy exists so the DYNAMIC order graph (MTR102) rediscovers it from
observed acquisitions alone, with both direction stacks in the report.

Never imported by the package — only by ``test_race_detector.py``.
"""

import threading
from typing import Any, Dict


class MiniTPE:
    """Every base-class path orders _launch_lock -> _kernel_lock."""

    def __init__(self) -> None:
        self._launch_lock = threading.Lock()
        self._kernel_lock = threading.Lock()
        self._launches = 0
        self._kernel = {"bandwidth": 1.0}

    def suggest(self) -> Dict[str, Any]:
        with self._launch_lock:
            self._launches += 1
            with self._kernel_lock:
                return dict(self._kernel)

    def state_dict(self) -> Dict[str, Any]:
        with self._launch_lock:
            return {"launches": self._launches}


class MiniMOTPE(MiniTPE):
    def state_dict(self) -> Dict[str, Any]:
        # BUG (the original shape): kernel lock taken FIRST, then super() takes
        # the launch lock — the reverse of every suggest path
        with self._kernel_lock:
            out = super().state_dict()
            out["kernel"] = dict(self._kernel)
            return out
