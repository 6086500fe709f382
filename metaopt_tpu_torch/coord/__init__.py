"""The coordinator: the single-writer trial-ledger service (port of
``metaopt_tpu/coord``).

One process owns the ledger and serves reserve/report/heartbeat to every
worker over a small TCP (or Unix-socket) channel; it also hosts one
algorithm per experiment on its device, so N workers share one fitted
surrogate.

- :mod:`~metaopt_tpu_torch.coord.protocol` — length-prefixed JSON framing
  and the binary v2 codec (msgpack, when installed).
- :mod:`~metaopt_tpu_torch.coord.wal` — the write-ahead log with
  group-commit fsync and torn-tail truncation.
- :mod:`~metaopt_tpu_torch.coord.tenancy` — fair produce scheduling.
- :mod:`~metaopt_tpu_torch.coord.fuser` — the fleet-fused suggest plane.
- :mod:`~metaopt_tpu_torch.coord.server` — :class:`CoordServer`.
- :mod:`~metaopt_tpu_torch.coord.client_backend` —
  :class:`CoordLedgerClient`, the ``"coord"`` ledger backend.
- :mod:`~metaopt_tpu_torch.coord.shards` — the routing helpers the server
  reads.

Sharded serving (``ShardRouter``, ``ShardSupervisor``, the hand-off) and
``pod.py`` are not ported yet.
"""

from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient
from metaopt_tpu_torch.coord.server import CoordServer

__all__ = ["CoordServer", "CoordLedgerClient"]
