"""Lint fixture: writes to a registered guarded attribute off-guard.

``put_unguarded`` assigns into the reply cache without the lock;
``evict_unguarded`` mutates it through ``.pop``; ``put_guarded`` is the
clean control inside the same module.
"""

import threading


class ReplyCache:
    def __init__(self):
        self._replies_lock = threading.Lock()
        self._replies = {}

    def put_guarded(self, req, reply):
        with self._replies_lock:
            self._replies[req] = reply

    def put_unguarded(self, req, reply):
        self._replies[req] = reply

    def evict_unguarded(self, req):
        self._replies.pop(req, None)
