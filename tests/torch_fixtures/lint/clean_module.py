"""Lint fixture: the clean counterpart for every rule.

Same shapes as the bad fixtures — consistent lock order, guarded writes
under their guard, I/O outside the no-block lock, donation followed by
reassignment, a pure jitted kernel, a pure hotpath function, hashable
static args, and a dispatch branch that journals before returning.
Every checker must stay silent here.
"""

import functools
import os
import threading

import jax


class Orderly:
    def __init__(self, f):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._replies_lock = threading.Lock()
        self._replies = {}
        self._f = f

    def forward(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def also_forward(self):
        with self._a_lock:
            with self._b_lock:
                return 2

    def put(self, req, reply):
        with self._replies_lock:
            self._replies[req] = reply

    def evict(self, req):
        with self._replies_lock:
            self._replies.pop(req, None)

    def flush(self):
        buf = None
        with self._b_lock:
            buf, self._f = self._f, None
        if buf is not None:
            os.fsync(buf.fileno())


class BaseSnap:
    def __init__(self):
        self._a_lock = threading.RLock()
        self._b_lock = threading.RLock()

    def snapshot(self):
        with self._a_lock:
            with self._b_lock:
                return {}


class SubSnap(BaseSnap):
    def snapshot(self):
        # the documented order end-to-end: a then b, and super() merely
        # re-acquires both re-entrantly — no new ordering edge
        with self._a_lock:
            with self._b_lock:
                s = super().snapshot()
        return s


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("k",))
def bump(buf, k=1):
    return buf + k


def roll(buf):
    buf = bump(buf, k=2)
    return buf


# mtpu: hotpath
def pure_math(x):
    return x * x


class GoodServer:
    _MUTATING_OPS = frozenset({"register"})
    _DURABLE_OPS = frozenset({"register"})

    def __init__(self, inner, wal):
        self.inner = inner
        self._wal = wal

    def _dispatch(self, op, a):
        if op == "register":
            self.inner.put(a["trial"])
            self._wal.append({"op": "put", "trial": a["trial"]})
            return None
        raise ValueError(op)
