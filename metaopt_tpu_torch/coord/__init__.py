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
- :mod:`~metaopt_tpu_torch.coord.shards` — sharded serving: N CoordServer
  subprocesses behind one consistent-hash shard map
  (:class:`ShardSupervisor` spawn/health-check/restart-with-recovery or
  failover, :class:`ShardRouter` old-client fallback proxy; new clients
  learn the map from the ping ``caps`` and route directly).
- :mod:`~metaopt_tpu_torch.coord.handoff` — live migration of one
  experiment between shards, and the offline recovery failover uses.
- :mod:`~metaopt_tpu_torch.coord.pod` — one coordinator per pod, its
  address broadcast over the ranks' process group.
"""

from metaopt_tpu_torch.coord.client_backend import CoordLedgerClient
from metaopt_tpu_torch.coord.server import CoordServer
from metaopt_tpu_torch.coord.shards import (HashRing, ShardRouter,
                                            ShardSupervisor)

__all__ = ["CoordServer", "CoordLedgerClient", "HashRing", "ShardRouter",
           "ShardSupervisor"]
