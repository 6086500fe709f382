"""Lint fixture: binary-wire opcode-table drift (MTD004).

``register`` is declared journaled (test config) and reaches a journal
call, and the server op sets agree — MTD001-003 stay silent. But the
module's ``WIRE_OPCODES`` table drifted three ways: ``register`` itself
is missing (a journaled op whose binary requests would carry the
opcode-0 'unknown' hint), ``fetch`` and ``count`` collide on opcode 2,
and ``probe`` squats on the reserved opcode 0.
"""

WIRE_OPCODES = {
    "ping": 1,
    "fetch": 2,
    "count": 2,
    "probe": 0,
}


class DriftServer:
    _MUTATING_OPS = frozenset({"register"})
    _DURABLE_OPS = frozenset({"register"})

    def __init__(self, inner, wal):
        self.inner = inner
        self._wal = wal

    def _dispatch(self, op, a):
        if op == "register":
            self._wal.append({"op": "put_trial", "trial": a["trial"]})
            self.inner.put(a["trial"])
            return None
        raise ValueError(op)
