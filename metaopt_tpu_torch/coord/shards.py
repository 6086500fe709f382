"""Shard-map routing helpers (port of ``metaopt_tpu/coord/shards.py``,
trimmed to what the single-process server reads).

The server names an op's experiment with :func:`experiment_of` (its lock,
its eviction fence and the v2 routing key) and reads the map version of a
snapshot or WAL record with :func:`map_version`; :class:`HashRing` and
:class:`RoutingTable` place experiments on shards by a process-independent
hash. ``ShardRouter``, ``ShardSupervisor``, ``with_override``,
``without_shard`` and the hand-off are not ported yet: the server refuses a
``shard_id`` / ``shard_map`` other than ``None``.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, List, Optional, Tuple

SHARD_MAP_VERSION = 1
#: virtual nodes per shard on the ring — enough that a 2..16-shard map
#: balances experiment ownership to within a few percent
DEFAULT_VNODES = 64


def stable_hash(key: str) -> int:
    """Process-independent 64-bit hash of ``key``.

    Python's builtin ``hash()`` is salted per process — every router,
    shard, and client must place an experiment at the SAME ring position,
    so the hash has to be deterministic across processes and runs.
    """
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8],
                          "big")


def experiment_of(op: Optional[str], args: Dict[str, Any]) -> Optional[str]:
    """The routing key (experiment id) of one request, or None.

    Mirrors ``_ShardedLedger._exp_of`` — the same derivation the server
    uses to pick a lock picks the shard: trial-payload ops ride the
    trial doc's ``experiment``, ``create_experiment`` the config's
    ``name``, everything else the explicit ``experiment``/``name`` arg.
    Requests with no key (ping, list_experiments, snapshot) are
    pan-shard and handled by the caller.
    """
    exp = args.get("experiment")
    if isinstance(exp, str):
        return exp
    if op == "create_experiment":
        cfg = args.get("config") or {}
        name = cfg.get("name")
        return name if isinstance(name, str) else None
    trial = args.get("trial")
    if isinstance(trial, dict):
        t_exp = trial.get("experiment")
        if isinstance(t_exp, str):
            return t_exp
    name = args.get("name")
    return name if isinstance(name, str) else None


class HashRing:
    """Consistent-hash ring: shard ids placed at ``vnodes`` points each.

    ``owner(key)`` is the first point clockwise of ``hash(key)`` —
    adding/removing one shard remaps only ~1/N of the keyspace, which is
    what makes the stretch goal (experiment hand-off on rebalance)
    tractable later without re-routing the world.
    """

    def __init__(self, shard_ids: List[str],
                 vnodes: int = DEFAULT_VNODES) -> None:
        if not shard_ids:
            raise ValueError("hash ring needs at least one shard")
        points = []
        for sid in shard_ids:
            for v in range(vnodes):
                points.append((stable_hash(f"{sid}#{v}"), sid))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [sid for _, sid in points]

    def owner(self, key: str) -> str:
        i = bisect.bisect_right(self._hashes, stable_hash(key))
        return self._owners[i % len(self._owners)]


def make_shard_map(shards: List[Tuple[str, str, int]],
                   vnodes: int = DEFAULT_VNODES) -> Dict[str, Any]:
    """Wire-form shard map from ``[(shard_id, host, port), …]``."""
    return {
        "version": SHARD_MAP_VERSION,
        "vnodes": int(vnodes),
        "shards": [
            {"id": sid, "host": host, "port": int(port)}
            for sid, host, port in shards
        ],
    }


def ring_of(shard_map: Dict[str, Any]) -> HashRing:
    return HashRing([s["id"] for s in shard_map["shards"]],
                    vnodes=int(shard_map.get("vnodes", DEFAULT_VNODES)))


def shard_addrs(shard_map: Dict[str, Any]) -> Dict[str, Tuple[str, int]]:
    """shard id → (host, port), in map order."""
    return {s["id"]: (s["host"], int(s["port"]))
            for s in shard_map["shards"]}


class RoutingTable:
    """Overrides-aware routing view of ONE shard-map version.

    A hand-off pins the moved experiment to its new owner via the map's
    ``overrides`` dict (experiment → shard id) so the move does not have
    to wait for ring churn; the ring stays the default for every
    un-pinned key. ``owner()`` keeps the HashRing signature, so every
    caller that used to hold a ring can hold a table instead.
    """

    def __init__(self, shard_map: Dict[str, Any]) -> None:
        self.shard_map = shard_map
        self.version = int(shard_map.get("version", 0))
        self.overrides: Dict[str, str] = dict(
            shard_map.get("overrides") or {})
        self.addrs = shard_addrs(shard_map)
        self._ring = ring_of(shard_map)

    def owner(self, key: str) -> str:
        sid = self.overrides.get(key)
        return sid if sid is not None else self._ring.owner(key)


def map_version(shard_map: Optional[Dict[str, Any]]) -> int:
    return int(shard_map.get("version", 0)) if shard_map else -1
