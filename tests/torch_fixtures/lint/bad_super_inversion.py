"""Lint fixture: MTL001 through ``super()`` (the MOTPE.state_dict bug).

The base class documents the order a -> b. The subclass grabs the
INHERITED b lock alone, then calls ``super()`` into base code that
re-takes a -> b: with another thread inside ``snapshot()`` holding a and
waiting for b, the pair AB-BA-deadlocks. Canonicalization must put the
subclass's acquisition on the base class's lock node for the cycle to
close.
"""

import threading


class BaseAlgo:
    def __init__(self):
        self._a_lock = threading.RLock()
        self._b_lock = threading.RLock()

    def snapshot(self):
        # documented order: a -> b
        with self._a_lock:
            with self._b_lock:
                return {}


class SubAlgo(BaseAlgo):
    def snapshot_wrapped(self):
        # holds the inherited b lock while super() re-enters via a: b -> a
        with self._b_lock:
            s = super().snapshot()
        return s
