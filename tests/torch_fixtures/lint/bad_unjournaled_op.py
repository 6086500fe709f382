"""Lint fixture: durability-contract violations.

``register`` is declared journaled (test config) but its dispatch branch
mutates the inner store without any journal call -> MTD001. ``purge``
mutates (it is in ``_MUTATING_OPS``) but is not declared journaled ->
MTD002; it is also missing from ``_DURABLE_OPS`` so even a declared op
would never wait on the fsync barrier.
"""


class BadServer:
    _MUTATING_OPS = frozenset({"register", "purge"})
    _DURABLE_OPS = frozenset({"register"})

    def __init__(self, inner, wal):
        self.inner = inner
        self._wal = wal

    def _dispatch(self, op, a):
        if op == "register":
            self.inner.put(a["trial"])
            return None
        if op == "purge":
            self.inner.drop_all()
            return None
        raise ValueError(op)
