"""Lint fixture (never imported, only parsed): AB-BA lock inversion.

``forward`` acquires a -> b, ``backward`` acquires b -> a; the
lock-acquisition graph has a 2-cycle and MTL001 must fire on both edges.
"""

import threading


class Inverted:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def forward(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def backward(self):
        with self._b_lock:
            with self._a_lock:
                return 2
