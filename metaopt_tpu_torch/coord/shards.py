"""Sharded serving: N coordinator processes behind one consistent-hash map
(port of ``metaopt_tpu/coord/shards.py``).

The single Python coordinator process is GIL-bound; only more processes
scale it. This module runs several while keeping every per-shard
guarantee intact:

- **Sharding unit = experiment.** Every request that names an experiment
  (directly, via a trial doc, or via a config) is owned by exactly one
  shard, chosen by a consistent-hash ring over the experiment id
  (:class:`HashRing`). A shard is a full, unmodified
  :class:`~metaopt_tpu_torch.coord.server.CoordServer` subprocess with its
  OWN WAL + crash-atomic snapshot + journaled reply cache, so the
  durability and exactly-once story is per-shard verbatim.
- **Routing, two ways (rolling-upgrade safe both directions).** New
  clients learn the shard map from the ``ping`` reply (cap
  ``"shard_map"``) and route DIRECTLY to the owning shard — zero extra
  hops on the hot path. Old clients that ignore the cap keep talking to
  the public address, where a thin stdlib :class:`ShardRouter` decodes
  just enough of each frame to pick the shard, forwards the raw payload,
  and relays the raw reply — request ids pass through untouched, so the
  shard's journaled reply cache still gives exactly-once across
  router-side retries.
- **Recovery isolation.** :class:`ShardSupervisor` spawns shards as
  subprocesses (``python -m metaopt_tpu_torch.coord.shards``), waits for
  each one's ``coordinator ready`` line (which doubles as the
  recovery-complete signal — restore + WAL replay happen inside
  ``start()``), and restarts any shard that dies on the SAME
  snapshot/WAL paths, or with ``failover=True`` hands its experiments to
  the survivors.
- **One device context per shard.** Each shard process resolves its own
  ``--device`` (``cuda`` unless the caller passes another) and hosts the
  TPE / GP-BO of the experiments it owns there. The supervisor and the
  router never touch torch: they pass the device name on and relay
  bytes, so a card holds exactly one context per shard.

The hash uses md5, not Python's builtin ``hash()`` — the builtin is
salted per process (PYTHONHASHSEED), and a ring that two processes
disagree on routes every request wrong.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import signal as _signal_mod
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from metaopt_tpu_torch.coord.protocol import (
    ProtocolError,
    WIRE_OPCODES,
    decode_payload,
    encode_msg,
    encode_reply_v2,
    payload_is_v2,
    recv_payload,
    reply_shard_miss,
    request_opcode,
    request_routing_key,
    send_msg,
    send_payload,
)

log = logging.getLogger(__name__)

SHARD_MAP_VERSION = 1
#: virtual nodes per shard on the ring — enough that a 2..16-shard map
#: balances experiment ownership to within a few percent
DEFAULT_VNODES = 64

#: the ping cap a shard-map-aware server (or the router) advertises;
#: clients that know it read ``shard_map`` off the ping reply and route
#: directly, clients that don't simply keep using the address they have
SHARD_MAP_CAP = "shard_map"

#: the ops the router answers itself rather than relaying; a v2 request
#: whose header opcode is outside this set is routed WITHOUT decoding
_PAN_SHARD_OPS = ("ping", "list_experiments", "snapshot", "tenant_stats")
_PAN_SHARD_OPCODES = frozenset(WIRE_OPCODES[op] for op in _PAN_SHARD_OPS)


def stable_hash(key: str) -> int:
    """Process-independent 64-bit hash of ``key``.

    Python's builtin ``hash()`` is salted per process — every router,
    shard, and client must place an experiment at the SAME ring position,
    so the hash has to be deterministic across processes and runs.
    """
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8],
                          "big")


def merge_tenant_stats(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-shard ``tenant_stats`` replies into one pod-wide view.

    Counters are additive (each shard only grants produce legs for the
    experiments it owns); a tenant's weight is configuration, identical
    on every shard, so any shard's value stands.
    """
    out: Dict[str, Any] = {
        "tenants": {}, "resident": 0, "evicted": 0,
        "evictions": 0, "hydrations": 0,
    }
    for part in parts:
        if not isinstance(part, dict):
            continue
        for key in ("resident", "evicted", "evictions", "hydrations"):
            out[key] += int(part.get(key) or 0)
        for tenant, row in (part.get("tenants") or {}).items():
            acc = out["tenants"].setdefault(tenant, {
                "granted": 0, "denied": 0, "experiments": 0,
                "evicted": 0, "weight": row.get("weight", 1.0),
            })
            for key in ("granted", "denied", "experiments", "evicted"):
                acc[key] += int(row.get(key) or 0)
        if "experiments" in part:
            out.setdefault("experiments", {}).update(
                part["experiments"] or {})
    return out


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


def with_override(shard_map: Dict[str, Any], experiment: str,
                  dest_sid: str) -> Dict[str, Any]:
    """A version-bumped copy of the map pinning ``experiment`` to
    ``dest_sid`` (or un-pinning it when that is its natural ring owner)."""
    if dest_sid not in shard_addrs(shard_map):
        raise ValueError(f"unknown destination shard {dest_sid!r}")
    new = json.loads(json.dumps(shard_map))
    overrides = dict(new.get("overrides") or {})
    if ring_of(new).owner(experiment) == dest_sid:
        overrides.pop(experiment, None)
    else:
        overrides[experiment] = dest_sid
    new["overrides"] = overrides
    new["version"] = map_version(shard_map) + 1
    return new


def without_shard(shard_map: Dict[str, Any], dead_sid: str
                  ) -> Dict[str, Any]:
    """A version-bumped copy of the map with ``dead_sid`` removed.

    Overrides that pinned experiments to the dead shard are dropped —
    the shrunken ring's natural owner (always a survivor) takes over;
    survivors' own keys don't move, that is the point of the
    consistent hash.
    """
    new = json.loads(json.dumps(shard_map))
    new["shards"] = [s for s in new["shards"] if s["id"] != dead_sid]
    if not new["shards"]:
        raise ValueError("cannot remove the last shard from the map")
    new["overrides"] = {e: s
                       for e, s in (new.get("overrides") or {}).items()
                       if s != dead_sid}
    new["version"] = map_version(shard_map) + 1
    return new


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# router — the old-client fallback path
# ---------------------------------------------------------------------------

class ShardRouter:
    """Thin stdlib proxy for clients that don't speak the shard map.

    Per client connection, one thread: decode the request frame (JSON —
    only to read ``op``/``args`` for the routing key), forward the raw
    payload to the owning shard over a per-connection upstream socket,
    and relay the shard's raw reply bytes verbatim. No reply re-encode,
    no state: the request id inside the payload reaches the shard
    unmodified, so retries the router itself performs after an upstream
    drop are answered exactly-once from the shard's journaled reply
    cache — the router adds a hop, never a semantics change.

    Pan-shard ops are the only ones the router answers itself:

    - ``ping`` → forwarded to the first shard, then augmented with the
      shard map + the ``shard_map`` cap, so even a via-router ping
      teaches a NEW client to go direct on its next call.
    - ``list_experiments`` → fan-out, merged + sorted.
    - ``snapshot`` → fan-out; each shard snapshots its own configured
      path (or ``<path>.<shard id>`` when the caller named one).

    A dead upstream is retried with decorrelated jitter inside
    ``reconnect_window_s`` (a shard restart + replay window); past it
    the client connection is dropped and the old client's own
    reconnect/retry logic takes over.
    """

    def __init__(self, shard_map: Dict[str, Any], host: str = "127.0.0.1",
                 port: int = 0, reconnect_window_s: float = 30.0) -> None:
        self.shard_map = shard_map
        self.reconnect_window_s = reconnect_window_s
        #: routing state (shard_map/_table/_addrs/_first_sid) is read per
        #: request and replaced wholesale by update_map() after a
        #: hand-off/failover — all of it lives under _map_lock
        self._map_lock = threading.Lock()
        self._table = RoutingTable(shard_map)
        self._addrs = shard_addrs(shard_map)
        self._first_sid = shard_map["shards"][0]["id"]
        self._bind = (host, port)
        self._sock: Optional[socket.socket] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._stopping = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        assert self._sock is not None, "router not started"
        return self._sock.getsockname()[:2]

    def start(self) -> "ShardRouter":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._bind)
        self._sock.listen(128)
        # counted before the accept thread starts: from then on a
        # connection's ping may swap _addrs under _map_lock (update_map)
        with self._map_lock:
            n_shards = len(self._addrs)
        t = threading.Thread(target=self._accept_loop,
                             name="coord-router-accept", daemon=True)
        t.start()
        self._threads.append(t)
        log.info("shard router listening on %s:%d (%d shards)",
                 *self.address, n_shards)
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._sock is not None:
            # shutdown() before close(): same accept()-never-wakes doctrine
            # as CoordServer.stop()
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)

    def __enter__(self) -> "ShardRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- map churn ---------------------------------------------------------
    def update_map(self, new_map: Dict[str, Any]) -> bool:
        """Adopt ``new_map`` iff its version is strictly newer.

        Called by the supervisor after a hand-off/failover commit and by
        the relay path itself when a shard's reply reveals a newer map.
        Monotonic: a stale lower-version map (a slow pre-migration ping
        racing the commit) can never roll the routing table back.
        """
        with self._map_lock:
            if map_version(new_map) <= self._table.version:
                return False
            self.shard_map = new_map
            self._table = RoutingTable(new_map)
            self._addrs = shard_addrs(new_map)
            self._first_sid = new_map["shards"][0]["id"]
        log.info("router adopted shard map v%d (%d shards, %d overrides)",
                 map_version(new_map), len(new_map["shards"]),
                 len(new_map.get("overrides") or {}))
        return True

    def _refresh_map(self, sid: str,
                     upstream: Dict[str, socket.socket]) -> None:
        """Best-effort: ping shard ``sid`` and adopt any newer map it
        advertises (post-commit, the migration source/survivors all carry
        the bumped map)."""
        try:
            reply = decode_payload(self._forward(
                sid, encode_msg({"op": "ping", "args": {}}), upstream))
            smap = (reply.get("result") or {}).get("shard_map") \
                if reply.get("ok") else None
            if smap:
                self.update_map(smap)
        except (ConnectionError, BrokenPipeError, OSError, ProtocolError,
                json.JSONDecodeError, KeyError):
            log.debug("router map refresh via %s failed", sid,
                      exc_info=True)

    @staticmethod
    def _routing_miss(reply: Dict[str, Any]) -> bool:
        """True for the two retryable mid-migration answers."""
        return (not reply.get("ok")
                and reply.get("error") in ("WrongShardError", "Migrating"))

    # -- relay plumbing ----------------------------------------------------
    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="coord-router-conn", daemon=True)
            t.start()

    def _connect(self, sid: str) -> socket.socket:
        with self._map_lock:
            addr = self._addrs[sid]
        s = socket.create_connection(addr, timeout=10.0)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(None)
        return s

    def _forward(self, sid: str, payload: bytes,
                 upstream: Dict[str, socket.socket]) -> bytes:
        """Send ``payload`` to shard ``sid``; return the raw reply payload.

        Retries through a shard restart: the resent payload carries the
        SAME request id, so a mutating op that executed before the crash
        is answered from the shard's journaled reply cache, not re-run.
        """
        from metaopt_tpu_torch.coord.client_backend import decorrelated_jitter

        deadline = time.monotonic() + self.reconnect_window_s
        delay = 0.0
        while True:
            try:
                s = upstream.get(sid)
                if s is None:
                    s = upstream[sid] = self._connect(sid)
                send_payload(s, payload)
                reply = recv_payload(s)
                if reply is None:
                    raise ConnectionError("shard closed the connection")
                return reply
            except (ConnectionError, BrokenPipeError, OSError,
                    ProtocolError):
                stale = upstream.pop(sid, None)
                if stale is not None:
                    try:
                        stale.close()
                    except OSError:
                        pass
                if (self._stopping.is_set()
                        or time.monotonic() >= deadline):
                    raise
                delay = decorrelated_jitter(delay)
                time.sleep(delay)

    def _fanout(self, msg: Dict[str, Any],
                upstream: Dict[str, socket.socket]) -> List[Dict[str, Any]]:
        """One reply dict per shard, in map order; raises on dead shard.

        A shard that answers ``WrongShardError``/``Migrating`` is
        mid-hand-off, not broken: refresh the map from it and re-run the
        fan-out against the (possibly newer) shard set instead of
        surfacing a transient routing error to an old client.
        """
        from metaopt_tpu_torch.coord.client_backend import decorrelated_jitter

        deadline = time.monotonic() + self.reconnect_window_s
        delay = 0.0
        while True:
            with self._map_lock:
                sids = list(self._addrs)
            replies = []
            stale_sid = None
            for sid in sids:
                a = dict(msg.get("args") or {})
                if msg.get("op") == "snapshot" and a.get("path"):
                    # each shard owns its own snapshot file — a shared
                    # literal path would have N processes racing one
                    # atomic rename
                    a["path"] = f"{a['path']}.{sid}"
                try:
                    r = decode_payload(self._forward(
                        sid, encode_msg({**msg, "args": a}), upstream))
                except KeyError:
                    # the sid left the map mid-fan-out (failover shrank
                    # the ring): re-run against the current shard set
                    stale_sid = sid
                    replies = None
                    break
                if self._routing_miss(r):
                    stale_sid = sid
                replies.append(r)
            if replies is not None and (stale_sid is None
                                        or time.monotonic() >= deadline):
                return replies
            self._refresh_map(stale_sid, upstream)
            delay = decorrelated_jitter(delay)
            time.sleep(delay)

    def _ping_reply(self, msg: Dict[str, Any],
                    upstream: Dict[str, socket.socket]) -> Dict[str, Any]:
        with self._map_lock:
            first_sid = self._first_sid
        reply = decode_payload(self._forward(
            first_sid, encode_msg(msg), upstream))
        if reply.get("ok"):
            res = reply["result"]
            # a post-hand-off shard may advertise a newer map than the
            # router has seen — adopt it before echoing a map back
            smap = res.get("shard_map")
            if smap:
                self.update_map(smap)
            caps = set(res.get("caps") or ())
            caps.add(SHARD_MAP_CAP)
            res["caps"] = sorted(caps)
            with self._map_lock:
                res["shard_map"] = self.shard_map
            # the first shard's shard_id is ITS identity, not this
            # connection's — a routed client has no single shard
            res.pop("shard_id", None)
            res.pop("pid", None)
            # ditto its Unix socket: a same-host client that adopted it
            # would dial shard 0 directly for SEED traffic and bypass
            # the router's fan-out ops entirely
            res.pop("uds_path", None)
        return reply

    def _relay(self, conn: socket.socket, payload: bytes,
               exp: Optional[str],
               upstream: Dict[str, socket.socket]) -> None:
        """Forward one experiment-keyed request payload verbatim (either
        codec), chasing a live hand-off.

        ``Migrating`` means the owner is quiescing the experiment (retry
        the same shard until the commit lands); ``WrongShardError`` means
        ownership already moved (refresh the map and follow it). Past the
        window the last reply — whatever it was — is surfaced.
        """
        from metaopt_tpu_torch.coord.client_backend import decorrelated_jitter

        deadline = time.monotonic() + self.reconnect_window_s
        delay = 0.0
        while True:
            with self._map_lock:
                sid = (self._table.owner(exp) if exp is not None
                       else self._first_sid)
            try:
                raw = self._forward(sid, payload, upstream)
            except KeyError:
                # the owner left the map mid-forward (failover shrank the
                # ring under a connect retry): re-resolve against the new
                # table — the shrunken ring names a survivor
                if time.monotonic() >= deadline:
                    raise ConnectionError(f"shard {sid} left the map")
                delay = decorrelated_jitter(delay)
                time.sleep(delay)
                continue
            if exp is not None:
                if payload_is_v2(raw):
                    # two header bytes say miss-or-not — no body decode
                    miss = reply_shard_miss(raw)
                else:
                    # cheap sniff before a JSON parse: routing misses are
                    # tiny error frames, hot replies pass untouched
                    miss = None
                    if (len(raw) < 512 and (b"WrongShardError" in raw
                                            or b"Migrating" in raw)):
                        reply = json.loads(raw)
                        if self._routing_miss(reply):
                            miss = reply["error"]
                if miss is not None and time.monotonic() < deadline:
                    self._refresh_map(sid, upstream)
                    delay = decorrelated_jitter(delay)
                    time.sleep(delay)
                    continue
            send_payload(conn, raw)
            return

    @staticmethod
    def _send_reply(conn: socket.socket, reply: Dict[str, Any],
                    wire: str) -> None:
        """A router-composed reply, in the codec the request arrived in."""
        if wire == "v2":
            try:
                send_payload(conn, encode_reply_v2(reply))
                return
            except ProtocolError:
                pass  # unencodable body: this one frame goes JSON
        send_msg(conn, reply)

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._conns_lock:
            self._conns.add(conn)
        upstream: Dict[str, socket.socket] = {}
        try:
            while not self._stopping.is_set():
                try:
                    payload = recv_payload(conn)
                except (ProtocolError, ConnectionError, OSError):
                    return
                if payload is None or self._stopping.is_set():
                    return
                v2 = payload_is_v2(payload)
                if v2 and request_opcode(payload) not in _PAN_SHARD_OPCODES:
                    # the zero-parse hot path: a v2 request's routing key
                    # sits at a fixed header offset, so the router picks
                    # the shard and forwards the frame verbatim without
                    # ever decoding the body. (A foreign v2 encoder that
                    # sets opcode 0 on a pan-shard op degrades to a relay
                    # to the owning/first shard — still a correct answer,
                    # minus the router's map augmentation.)
                    try:
                        exp = request_routing_key(payload)
                        self._relay(conn, payload, exp, upstream)
                    except (ConnectionError, BrokenPipeError, OSError,
                            ProtocolError, KeyError):
                        return
                    continue
                # pan-shard v2 ops and every JSON frame: decode for
                # op/args (JSON routing needs the body; pan-shard replies
                # are composed here)
                try:
                    msg = decode_payload(payload)
                except (ProtocolError, json.JSONDecodeError):
                    return
                op = msg.get("op")
                wire = "v2" if v2 else "v1"
                try:
                    if op == "ping":
                        self._send_reply(conn, self._ping_reply(
                            msg, upstream), wire)
                        continue
                    if op == "list_experiments":
                        replies = self._fanout(msg, upstream)
                        bad = next(
                            (r for r in replies if not r.get("ok")), None)
                        if bad is None:
                            names = sorted(
                                {n for r in replies for n in r["result"]})
                            self._send_reply(
                                conn, {"ok": True, "result": names}, wire)
                        else:
                            self._send_reply(conn, bad, wire)
                        continue
                    if op == "snapshot":
                        replies = self._fanout(msg, upstream)
                        bad = next(
                            (r for r in replies if not r.get("ok")), None)
                        if bad is None:
                            self._send_reply(conn, {
                                "ok": True,
                                "result": ";".join(
                                    str(r["result"]) for r in replies),
                            }, wire)
                        else:
                            self._send_reply(conn, bad, wire)
                        continue
                    if op == "tenant_stats":
                        # per-shard tenant accounting merges additively:
                        # each shard grants produce legs only for the
                        # experiments it owns, so summing counters (and
                        # unioning residency) is the pod-wide truth
                        replies = self._fanout(msg, upstream)
                        bad = next(
                            (r for r in replies if not r.get("ok")), None)
                        if bad is None:
                            self._send_reply(conn, {
                                "ok": True,
                                "result": merge_tenant_stats(
                                    [r["result"] for r in replies]),
                            }, wire)
                        else:
                            self._send_reply(conn, bad, wire)
                        continue
                    exp = experiment_of(op, msg.get("args") or {})
                    self._relay(conn, payload, exp, upstream)
                except (ConnectionError, BrokenPipeError, OSError,
                        ProtocolError, KeyError):
                    # upstream stayed dead past the window, or the client
                    # side broke mid-reply: drop the connection and let
                    # the client's own retry take over
                    return
        finally:
            for s in upstream.values():
                try:
                    s.close()
                except OSError:
                    pass
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# supervisor — spawn, health-check, restart-with-recovery
# ---------------------------------------------------------------------------

class _ShardProc:
    """One shard incarnation: its process + ready signal + stdout drain."""

    __slots__ = ("proc", "ready", "lines", "elapsed", "t0", "reader")

    def __init__(self, proc: subprocess.Popen, t0: float) -> None:
        self.proc = proc
        self.ready = threading.Event()
        self.lines: List[str] = []  # pre-ready output, for spawn errors
        self.elapsed: Optional[float] = None
        self.t0 = t0
        self.reader: Optional[threading.Thread] = None


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


class ShardSupervisor:
    """Spawn/health-check/restart N CoordServer shard subprocesses.

    Each shard runs ``python -m metaopt_tpu_torch.coord.shards`` on a fixed
    port with its own snapshot path (``shard-<i>.snap.json`` under
    ``snapshot_dir``), so a restart lands on the same WAL + snapshot and
    recovers exactly like the single-process crash path
    (tests/functional/test_coord_crash.py). The ``coordinator ready``
    stdout line doubles as the recovery-done signal; a per-shard drain
    thread keeps consuming output afterwards so a chatty shard can never
    block on a full pipe.

    The watcher respawns any dead shard with ``METAOPT_TPU_FAULTS``
    disarmed (a chaos fault fires once per test, same doctrine as the
    crash-test supervisor) and never blocks on the respawn's recovery —
    death detection stays 20 ms-granular for the OTHER shards, which is
    what "one shard's crash+replay never stalls the others" means at the
    supervision layer.

    ``router=True`` (default) also runs a :class:`ShardRouter` on the
    public ``(host, port)`` — the address old clients keep using; new
    clients learn the map from any ping and go direct.

    ``failover=True`` changes what death means: instead of respawning
    the dead shard, its experiments are recovered from its snapshot+WAL
    on disk and handed to the SURVIVORS via the live hand-off protocol
    (:mod:`metaopt_tpu_torch.coord.handoff`), shrinking the ring; survivors
    keep answering their own traffic throughout, and the wall time of
    each redistribution lands in ``failover_times``. ``handoff()`` runs
    the same protocol on demand for live rebalancing (``rebalance``).

    ``device`` is the device every shard hosts its algorithms on, passed
    to each shard process as ``--device`` (``None`` = ``cuda``). The
    supervisor never imports torch for it: a shard that cannot resolve
    its device fails before its ready line, and :meth:`start` raises with
    that shard's output.
    """

    def __init__(
        self,
        n_shards: int,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_dir: Optional[str] = None,
        snapshot_interval_s: float = 30.0,
        stale_timeout_s: Optional[float] = None,
        router: bool = True,
        restart: bool = True,
        failover: bool = False,
        vnodes: int = DEFAULT_VNODES,
        shard_ports: Optional[List[int]] = None,
        shard_env: Optional[Dict[int, Dict[str, str]]] = None,
        ready_timeout_s: float = 120.0,
        suggest_prefetch_depth: int = 1,
        event_log_dir: Optional[str] = None,
        produce_coalesce_ms: Optional[float] = None,
        evict_idle_s: Optional[float] = None,
        max_resident: Optional[int] = None,
        max_experiments: Optional[int] = None,
        max_experiments_per_tenant: Optional[int] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        fuse_suggest: bool = False,
        fuse_bucket_max: Optional[int] = None,
        device: Optional[str] = None,
    ) -> None:
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.n_shards = n_shards
        self.host = host
        self._public_port = port
        self.snapshot_dir = snapshot_dir
        self.snapshot_interval_s = snapshot_interval_s
        self.stale_timeout_s = stale_timeout_s
        self.suggest_prefetch_depth = suggest_prefetch_depth
        self.event_log_dir = event_log_dir
        self.produce_coalesce_ms = produce_coalesce_ms
        # multi-tenant knobs — forwarded verbatim to every shard; the
        # per-tenant admission caps apply PER SHARD (the router does not
        # pre-count), which is the conservative reading of a pod-wide cap
        self.evict_idle_s = evict_idle_s
        self.max_resident = max_resident
        self.max_experiments = max_experiments
        self.max_experiments_per_tenant = max_experiments_per_tenant
        self.tenant_weights = tenant_weights
        # fused suggest plane: forwarded to every shard (each shard fuses
        # across ITS resident experiments — buckets never span shards)
        self.fuse_suggest = fuse_suggest
        self.fuse_bucket_max = fuse_bucket_max
        #: the hosted algorithms' device, resolved by each shard process
        #: in its own CUDA context (a string: torch stays out of here)
        self.device = None if device is None else str(device)
        self.vnodes = vnodes
        self.ready_timeout_s = ready_timeout_s
        self._want_router = router
        self._want_restart = restart
        #: failover mode: a dead shard's experiments are recovered from
        #: its snapshot+WAL on disk and handed to the SURVIVORS instead
        #: of respawning it (requires ``snapshot_dir``; see _failover_shard)
        self._want_failover = failover and restart
        if failover and snapshot_dir is None:
            raise ValueError("failover mode needs a snapshot_dir to "
                             "recover a dead shard's state from")
        #: extra env per shard index, applied to the FIRST incarnation
        #: only — a chaos test arms METAOPT_TPU_FAULTS on one shard here
        self._shard_env = dict(shard_env or {})
        self._shard_ports = list(shard_ports or [])
        self.shard_map: Optional[Dict[str, Any]] = None
        self.router: Optional[ShardRouter] = None
        #: shard index → current incarnation; every past proc is also kept
        #: (in _all_procs) so stop() can reap and crashes() can count
        self._shards: Dict[int, _ShardProc] = {}
        self._all_procs: List[subprocess.Popen] = []
        #: wall time from each spawn to its ready line — entry 0 is the
        #: cold start, later entries are restart+recovery times
        self.recovery_times: List[float] = []
        #: wall time of each completed failover (death detected →
        #: survivors own every recovered experiment) — the
        #: failover time a caller reports
        self.failover_times: List[float] = []
        self._failover_threads: List[threading.Thread] = []
        self._procs_lock = threading.Lock()
        self._stopping = threading.Event()
        self._watcher: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        """The public seed address: router if running, else shard 0."""
        if self.router is not None:
            return self.router.address
        assert self.shard_map is not None, "supervisor not started"
        return shard_addrs(self.shard_map)[self.shard_map["shards"][0]["id"]]

    def shard_addresses(self) -> Dict[str, Tuple[str, int]]:
        assert self.shard_map is not None, "supervisor not started"
        return shard_addrs(self.shard_map)

    def start(self) -> "ShardSupervisor":
        while len(self._shard_ports) < self.n_shards:
            self._shard_ports.append(_free_port(self.host))
        with self._procs_lock:
            self.shard_map = make_shard_map(
                [(f"s{i}", self.host, self._shard_ports[i])
                 for i in range(self.n_shards)],
                vnodes=self.vnodes,
            )
        # spawn all shards first, then wait: cold starts overlap. Any
        # failure past the first spawn (a shard that never comes up, a
        # router port already bound) must reap every child already
        # spawned — a raised start() leaves nothing behind
        try:
            recs = [self._spawn(i, env_extra=self._shard_env.get(i))
                    for i in range(self.n_shards)]
            deadline = time.monotonic() + self.ready_timeout_s
            for i, rec in enumerate(recs):
                # a shard that exits before its ready line (one that cannot
                # resolve its device, say) fails the start at once rather
                # than after the whole ready timeout
                while not rec.ready.wait(0.05):
                    if (rec.proc.poll() is not None
                            or time.monotonic() >= deadline):
                        if rec.reader is not None:
                            rec.reader.join(timeout=5)
                        if rec.ready.is_set():
                            break  # ready, then died: the watcher's case
                        out = "".join(rec.lines)
                        raise RuntimeError(
                            f"shard {i} failed to start: {out}")
            if self._want_router:
                self.router = ShardRouter(self.shard_map, host=self.host,
                                          port=self._public_port).start()
        except BaseException:
            self.stop()
            raise
        if self._want_restart:
            self._watcher = threading.Thread(
                target=self._watch, name="coord-shard-watch", daemon=True)
            self._watcher.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        with self._procs_lock:
            fthreads = list(self._failover_threads)
        for t in fthreads:
            t.join(timeout=30)
        if self.router is not None:
            self.router.stop()
        with self._procs_lock:
            procs = list(self._all_procs)
            recs = list(self._shards.values())
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(_signal_mod.SIGTERM)  # snapshots first
        for proc in procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
        for rec in recs:
            if rec.reader is not None:
                rec.reader.join(timeout=5)
        for proc in procs:
            if proc.stdout is not None:
                proc.stdout.close()

    def __enter__(self) -> "ShardSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- chaos hooks -------------------------------------------------------
    def kill_shard(self, i: int) -> None:
        """SIGKILL shard ``i``'s current incarnation (chaos tests)."""
        with self._procs_lock:
            proc = self._shards[i].proc
        proc.kill()

    def crashes(self) -> int:
        with self._procs_lock:
            procs = list(self._all_procs)
        return sum(1 for p in procs
                   if p.poll() == -_signal_mod.SIGKILL)

    # -- spawn / watch -----------------------------------------------------
    def _shard_argv(self, i: int) -> List[str]:
        assert self.shard_map is not None
        argv = [
            sys.executable, "-m", "metaopt_tpu_torch.coord.shards",
            "--shard-id", f"s{i}",
            "--host", self.host,
            "--port", str(self._shard_ports[i]),
            "--shard-map", json.dumps(self.shard_map,
                                      separators=(",", ":")),
            "--snapshot-interval-s", str(self.snapshot_interval_s),
        ]
        if self.snapshot_dir:
            argv += ["--snapshot",
                     os.path.join(self.snapshot_dir,
                                  f"shard-{i}.snap.json")]
        if self.stale_timeout_s is not None:
            argv += ["--stale-timeout-s", str(self.stale_timeout_s)]
        if self.suggest_prefetch_depth != 1:
            argv += ["--suggest-prefetch-depth",
                     str(self.suggest_prefetch_depth)]
        if self.event_log_dir:
            argv += ["--event-log",
                     os.path.join(self.event_log_dir,
                                  f"shard-{i}.events.jsonl")]
        if self.produce_coalesce_ms is not None:
            argv += ["--produce-coalesce-ms",
                     str(self.produce_coalesce_ms)]
        if self.evict_idle_s is not None:
            argv += ["--evict-idle-s", str(self.evict_idle_s)]
        if self.max_resident is not None:
            argv += ["--max-resident", str(self.max_resident)]
        if self.max_experiments is not None:
            argv += ["--max-experiments", str(self.max_experiments)]
        if self.max_experiments_per_tenant is not None:
            argv += ["--max-experiments-per-tenant",
                     str(self.max_experiments_per_tenant)]
        if self.tenant_weights:
            argv += ["--tenant-weights",
                     json.dumps(self.tenant_weights,
                                separators=(",", ":"))]
        if self.fuse_suggest:
            argv += ["--fuse-suggest"]
        if self.fuse_bucket_max is not None:
            argv += ["--fuse-bucket-max", str(self.fuse_bucket_max)]
        if self.device is not None:
            argv += ["--device", self.device]
        return argv

    def _spawn(self, i: int, env_extra: Optional[Dict[str, str]] = None,
               disarm: bool = False) -> _ShardProc:
        env = dict(os.environ)
        # the child resolves `-m metaopt_tpu_torch.coord.shards` from the repo
        # root whether or not the package is installed
        root = _repo_root()
        env["PYTHONPATH"] = (
            root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else root
        )
        if env_extra:
            env.update(env_extra)
        if disarm:
            # restarts run clean: an armed chaos fault fires once per
            # incarnation, not in a crash loop
            env.pop("METAOPT_TPU_FAULTS", None)
        t0 = time.monotonic()
        proc = subprocess.Popen(
            self._shard_argv(i), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env,
        )
        rec = _ShardProc(proc, t0)
        rec.reader = threading.Thread(
            target=self._drain, args=(rec,),
            name=f"coord-shard-drain-{i}", daemon=True)
        rec.reader.start()
        with self._procs_lock:
            self._shards[i] = rec
            self._all_procs.append(proc)
        return rec

    def _drain(self, rec: _ShardProc) -> None:
        # recovery log lines (torn-tail truncation etc.) precede the ready
        # line on the merged pipe; after ready, keep draining so the shard
        # never blocks on a full pipe
        assert rec.proc.stdout is not None
        for line in rec.proc.stdout:
            if not rec.ready.is_set():
                rec.lines.append(line)
                if "coordinator ready" in line:
                    rec.elapsed = time.monotonic() - rec.t0
                    with self._procs_lock:
                        self.recovery_times.append(rec.elapsed)
                    rec.ready.set()
                    log.info("shard process %d ready in %.3f s",
                             rec.proc.pid, rec.elapsed)

    def _watch(self) -> None:
        while not self._stopping.wait(0.02):
            with self._procs_lock:
                items = list(self._shards.items())
            for i, rec in items:
                if rec.proc.poll() is not None and not self._stopping.is_set():
                    with self._procs_lock:
                        survivors = len(self._shards) - 1
                    if self._want_failover and survivors >= 1:
                        log.warning("shard %d died (rc=%s); failing its "
                                    "experiments over to %d survivor(s)",
                                    i, rec.proc.returncode, survivors)
                        t = threading.Thread(
                            target=self._failover_shard, args=(i,),
                            name=f"coord-shard-failover-{i}", daemon=True)
                        with self._procs_lock:
                            # drop the dead incarnation from the live set
                            # FIRST so the watcher never double-fires
                            self._shards.pop(i, None)
                            self._failover_threads.append(t)
                        t.start()
                        continue
                    log.warning("shard %d died (rc=%s); restarting with "
                                "recovery", i, rec.proc.returncode)
                    # respawn is non-blocking (readiness lands via the
                    # drain thread), so one shard's replay never delays
                    # death detection for the others
                    self._spawn(i, disarm=True)

    def _failover_shard(self, i: int) -> None:
        """Recover dead shard ``i``'s experiments onto the survivors.

        Runs in its own ``coord-shard-failover-{i}`` thread so death
        detection (and failover of a SECOND shard) never waits on this
        one's WAL replay. The dead shard's snapshot + WAL are read
        straight off disk (:func:`~metaopt_tpu_torch.coord.handoff.
        recover_shard_state`) and each experiment is pushed to its new
        owner through the same idempotent ``handoff_apply`` op a live
        migration uses — one recovery path, not two.
        """
        from metaopt_tpu_torch.coord.handoff import (
            apply_recovered, call_admin, recover_shard_state)

        t0 = time.monotonic()
        dead_sid = f"s{i}"
        try:
            with self._procs_lock:
                assert self.shard_map is not None
                cur = self.shard_map
            new_map = without_shard(cur, dead_sid)
            assert self.snapshot_dir is not None
            snap = os.path.join(self.snapshot_dir, f"shard-{i}.snap.json")
            states = recover_shard_state(snap, snap + ".wal")
            table = RoutingTable(new_map)
            for exp, state in sorted(states.items()):
                apply_recovered(exp, state, table.addrs[table.owner(exp)],
                                new_map)
            # every survivor must adopt the shrunken map (the applies
            # taught only each experiment's new owner)
            for addr in table.addrs.values():
                try:
                    call_admin(addr, "shard_map_update",
                               {"shard_map": new_map}, window_s=5.0)
                except Exception:
                    log.warning("failover: map broadcast to %s failed",
                                addr, exc_info=True)
            with self._procs_lock:
                if map_version(self.shard_map) < map_version(new_map):
                    self.shard_map = new_map
                self.failover_times.append(time.monotonic() - t0)
            if self.router is not None:
                self.router.update_map(new_map)
            log.warning("failover of shard %d done: %d experiment(s) "
                        "redistributed in %.2fs", i, len(states),
                        time.monotonic() - t0)
        except Exception:
            # a failed failover must not kill the watcher's process —
            # the experiments stay recoverable on disk for a retry/drill
            log.exception("failover of shard %d failed", i)

    # -- live rebalance ----------------------------------------------------
    def handoff(self, experiment: str, dest_sid: str,
                drain_timeout_s: float = 10.0,
                window_s: float = 30.0) -> Optional[Dict[str, Any]]:
        """Migrate ``experiment`` to ``dest_sid`` live; None if already
        there. Runs the full prepare→ship→apply→commit protocol
        (:func:`~metaopt_tpu_torch.coord.handoff.migrate_experiment`) and
        teaches the router + supervisor map the bumped version."""
        from metaopt_tpu_torch.coord.handoff import migrate_experiment

        with self._procs_lock:
            assert self.shard_map is not None, "supervisor not started"
            cur = self.shard_map
        table = RoutingTable(cur)
        source_sid = table.owner(experiment)
        if source_sid == dest_sid:
            return None
        new_map = with_override(cur, experiment, dest_sid)
        others = [a for sid, a in table.addrs.items()
                  if sid not in (source_sid, dest_sid)]
        result = migrate_experiment(
            experiment, table.addrs[source_sid], table.addrs[dest_sid],
            dest_sid, new_map, other_addrs=others,
            drain_timeout_s=drain_timeout_s, window_s=window_s)
        with self._procs_lock:
            if map_version(self.shard_map) < map_version(new_map):
                self.shard_map = new_map
        if self.router is not None:
            self.router.update_map(new_map)
        return result


# ---------------------------------------------------------------------------
# shard subprocess entry: python -m metaopt_tpu_torch.coord.shards
# ---------------------------------------------------------------------------

def _shard_main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m metaopt_tpu_torch.coord.shards",
        description="run ONE coordinator shard (normally spawned by "
                    "ShardSupervisor / `serve --shards N`)",
    )
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shard-map", default=None,
                    help="full shard map as inline JSON")
    ap.add_argument("--snapshot", default=None)
    ap.add_argument("--snapshot-interval-s", type=float, default=30.0)
    ap.add_argument("--stale-timeout-s", type=float, default=None)
    ap.add_argument("--event-log", default=None)
    ap.add_argument("--suggest-prefetch-depth", type=int, default=1)
    ap.add_argument("--produce-coalesce-ms", type=float, default=None)
    ap.add_argument("--evict-idle-s", type=float, default=None)
    ap.add_argument("--max-resident", type=int, default=None)
    ap.add_argument("--max-experiments", type=int, default=None)
    ap.add_argument("--max-experiments-per-tenant", type=int, default=None)
    ap.add_argument("--fuse-suggest", action="store_true", default=False)
    ap.add_argument("--fuse-bucket-max", type=int, default=None)
    ap.add_argument("--tenant-weights", default=None,
                    help="tenant→weight map as inline JSON")
    ap.add_argument("--device", default=None,
                    help="device of the hosted algorithms (default cuda; "
                         "raises without CUDA unless given cpu)")
    a = ap.parse_args(argv)

    from metaopt_tpu_torch.coord.server import CoordServer, serve_forever

    extra: Dict[str, Any] = {}
    if a.produce_coalesce_ms is not None:
        extra["produce_coalesce_ms"] = a.produce_coalesce_ms
    if a.evict_idle_s is not None:
        extra["evict_idle_s"] = a.evict_idle_s
    if a.max_resident is not None:
        extra["max_resident"] = a.max_resident
    if a.max_experiments is not None:
        extra["max_experiments"] = a.max_experiments
    if a.max_experiments_per_tenant is not None:
        extra["max_experiments_per_tenant"] = a.max_experiments_per_tenant
    if a.tenant_weights:
        extra["tenant_weights"] = json.loads(a.tenant_weights)
    if a.fuse_suggest:
        extra["fuse_suggest"] = True
    if a.fuse_bucket_max is not None:
        extra["fuse_bucket_max"] = a.fuse_bucket_max
    serve_forever(CoordServer(
        host=a.host,
        port=a.port,
        snapshot_path=a.snapshot,
        snapshot_interval_s=a.snapshot_interval_s,
        stale_timeout_s=a.stale_timeout_s,
        event_log_path=a.event_log,
        suggest_prefetch_depth=a.suggest_prefetch_depth,
        shard_id=a.shard_id,
        shard_map=json.loads(a.shard_map) if a.shard_map else None,
        device=a.device,
        **extra,
    ))


if __name__ == "__main__":
    _shard_main()
