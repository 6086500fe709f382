"""CoordLedgerClient — the ``"coord"`` ledger backend (port of
``metaopt_tpu/coord/client_backend.py``).

A drop-in :class:`~metaopt_tpu_torch.ledger.backends.LedgerBackend` whose every
method is one RPC to a :class:`~metaopt_tpu_torch.coord.server.CoordServer`. The
layers above (Experiment / Producer / workon) cannot tell the difference —
as a worker cannot tell a local database from a remote one.

Connections are per-(process, thread) and lazily rebuilt, so the client
survives ``fork``/``spawn`` into worker processes. Every call carries a
unique request id that is REUSED on the reconnect retry; the server caches
replies to mutating ops by request id, so a request whose reply was lost to
a **connection drop** is answered from cache instead of re-executed — that
makes retrying non-idempotent ops (``reserve``) safe across drops.

Against a WAL-enabled coordinator that guarantee now extends across a
coordinator *restart*: mutating replies are journaled, so a retry that
straddles the crash is answered from the REBUILT cache. The client does its
half of session resumption after every reconnect (``_after_reconnect``):
re-learns caps with a fresh ping, and when the ping reports a different
server ``incarnation`` (a real restart, not just a dropped connection),
re-asserts every reservation this client still holds via heartbeats — so
the recovered server's stale sweep never frees trials whose workers are
healthy. Reconnect attempts back off with decorrelated jitter so a
32-worker pod doesn't thundering-herd the coordinator the instant it
returns.

Against a sharded deployment (:mod:`metaopt_tpu_torch.coord.shards`) the
client learns the shard map from the seed's ``ping`` and routes every
experiment-named op straight to its owning shard; a ``WrongShardError``
(the map moved under it) re-learns the map and retries, and a
``Migrating`` reply (a hand-off or an eviction fences the experiment for
a moment) is waited out.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from metaopt_tpu_torch.coord.protocol import (
    HAVE_WIRE_V2,
    ProtocolError,
    decode_payload,
    encode_msg,
    encode_request_v2,
    recv_msg,
    recv_payload,
    send_msg,
    send_payload,
)
from metaopt_tpu_torch.coord.shards import (
    SHARD_MAP_CAP,
    RoutingTable,
    experiment_of,
    map_version,
)
from metaopt_tpu_torch.ledger.backends import (
    AdmissionError,
    DuplicateExperimentError,
    DuplicateTrialError,
    LedgerBackend,
    ledger_registry,
)
from metaopt_tpu_torch.ledger.trial import Trial

log = logging.getLogger(__name__)

_ERRORS = {
    "DuplicateTrialError": DuplicateTrialError,
    "DuplicateExperimentError": DuplicateExperimentError,
    "AdmissionError": AdmissionError,
    "KeyError": KeyError,
    "ValueError": ValueError,
}


def decorrelated_jitter(prev_s: float, base_s: float = 0.05,
                        cap_s: float = 2.0) -> float:
    """Next reconnect delay: ``min(cap, uniform(base, prev * 3))``.

    Decorrelated jitter (the exponential-backoff variant that spreads
    retries across the whole window instead of synchronized powers of
    two): when a restarted coordinator comes back, N workers that all
    died at the same instant wake at N different times instead of landing
    their reconnects in one thundering herd.
    """
    return min(cap_s, random.uniform(base_s, max(base_s, prev_s * 3.0)))


class CoordUnavailableError(ConnectionError):
    """The coordinator stayed unreachable through the reconnect window.

    Deliberately NOT a bare ``BrokenPipeError``/``OSError`` escape: the CLI
    treats ``BrokenPipeError`` as "stdout pipe closed, exit quietly", and a
    dead coordinator must never masquerade as that (exit 0 on a hard
    infrastructure failure).
    """


class CoordRPCError(RuntimeError):
    """Server-side failure that doesn't map to a known ledger exception."""


@ledger_registry.register("coord")
class CoordLedgerClient(LedgerBackend):
    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        connect_timeout_s: float = 10.0,
        reconnect_window_s: Optional[float] = None,
        wire: str = "auto",
        io_timeout_s: Optional[float] = None,
        **_: Any,
    ) -> None:
        self.host = host or os.environ.get("METAOPT_TPU_COORD_HOST", "127.0.0.1")
        self.port = int(port or os.environ.get("METAOPT_TPU_COORD_PORT", 0))
        if not self.port:
            raise ValueError("coord backend needs a port (coord://host:port)")
        self.connect_timeout_s = connect_timeout_s
        #: per-recv/send timeout once connected (the port's addition):
        #: None blocks as the reference does; a number turns a server
        #: that never answers into a dropped connection, retried through
        #: the reconnect window like any other drop
        self.io_timeout_s = io_timeout_s
        #: how long a call keeps retrying through coordinator downtime (a
        #: restart/preemption-reschedule window). 0 = legacy one-retry. The
        #: request id is reused across every retry, so the reply cache still
        #: gives exactly-once for drops within one server incarnation.
        if reconnect_window_s is None:
            reconnect_window_s = float(
                os.environ.get("METAOPT_TPU_COORD_RETRY_S", "0") or 0
            )
        self.reconnect_window_s = float(reconnect_window_s)
        if wire not in ("auto", "v1"):
            raise ValueError(f"wire must be 'auto' or 'v1', got {wire!r}")
        #: ``"auto"`` = negotiate wire v2 per address via ping caps;
        #: ``"v1"`` = force JSON everywhere (debugging, benchmarking the
        #: codecs against each other). Without msgpack there is nothing to
        #: negotiate, so auto collapses to v1.
        self.wire = wire if HAVE_WIRE_V2 else "v1"
        self._local = threading.local()
        #: optional-op capabilities advertised by the server's ping reply;
        #: None until the first probe. A modern server lists them up front
        #: ("caps"); against an older server this stays an empty tuple and
        #: every optional op degrades per-op on "unknown op" instead.
        self._caps: Optional[tuple] = None
        self._caps_lock = threading.Lock()
        #: server incarnation from the last ping — a reconnect that lands
        #: on a DIFFERENT incarnation crossed a restart and triggers
        #: session resumption (re-assert reservations, re-learn caps).
        #: Kept as the SEED address's incarnation; sharded serving tracks
        #: one per address in ``_incarnations`` below.
        self._incarnation: Optional[str] = None
        #: sharded serving (coord/shards.py): when the seed's ping
        #: advertises the "shard_map" cap, the map + ring live here (under
        #: ``_caps_lock``) and every experiment-named op routes DIRECTLY
        #: to the owning shard — the router hop is only for clients that
        #: never learned the map. Against an unsharded server all three
        #: stay empty and routing degrades to the seed address, so a new
        #: client on an old server is wire-identical to before.
        self._shard_map: Optional[Dict[str, Any]] = None
        self._ring = None
        self._shard_addrs: Dict[str, Tuple[str, int]] = {}
        #: version of the adopted map — adoption is MONOTONIC: a stale
        #: ping reply (raced with a hand-off commit) carrying a LOWER
        #: version must never roll routing back to the pre-migration
        #: owner, or acked writes would land on a shard about to drop
        #: the experiment. -1 = no map adopted yet.
        self._map_version: int = -1
        #: per-address incarnation from the last ping of THAT address —
        #: a reconnect to one shard compares against the shard's own
        #: identity, not the seed's
        self._incarnations: Dict[Tuple[str, int], str] = {}
        #: reservations this client currently holds: (experiment,
        #: trial_id) → worker. Maintained by reserve/worker_cycle/
        #: update_trial/heartbeat; re-asserted after a restart so the
        #: recovered server's stale sweep sees a fresh heartbeat instead
        #: of a crash-aged one.
        self._live: Dict[Tuple[str, str], str] = {}
        self._live_lock = threading.Lock()
        #: per-address negotiated wire ("v1"/"v2"), learned from that
        #: address's own ping reply (under ``_caps_lock``). Unknown
        #: addresses start on v1 — JSON is the lingua franca both
        #: directions of a rolling upgrade understand.
        self._addr_wire: Dict[Tuple[str, int], str] = {}
        #: consecutive v2 exchanges to an address where the SEND succeeded
        #: but the reply never came — the signature of a middlebox (an old
        #: JSON-only router relaying to a new shard) choking on binary.
        #: Three strikes force the address back to v1 for this client's
        #: lifetime; a clean v2 reply resets the count.
        self._v2_strikes: Dict[Tuple[str, int], int] = {}
        self._wire_blocked: set = set()
        #: same-host fast path: TCP address → the server-advertised Unix
        #: socket path, recorded only when the path exists locally (a ping
        #: relayed from another host advertises a path we can't reach).
        self._uds_paths: Dict[Tuple[str, int], str] = {}
        #: wire-level byte counters (payload + 4-byte length header per
        #: frame, both directions) — the coord_wire_bytes_per_trial
        #: benchmark row reads these.
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._io_lock = threading.Lock()

    # -- connection management --------------------------------------------
    @property
    def _seed(self) -> Tuple[str, int]:
        """The configured address — router or single server; the only one
        the client knows before a ping teaches it the shard map."""
        return (self.host, self.port)

    def _sock(self, addr: Optional[Tuple[str, int]] = None) -> socket.socket:
        # per-(pid, thread, address): a socket inherited across fork is
        # never reused, and a sharded map means one socket per shard
        addr = addr or self._seed
        socks = getattr(self._local, "pid_socks", None)
        if socks is None or socks[0] != os.getpid():
            socks = (os.getpid(), {})
            self._local.pid_socks = socks
        s = socks[1].get(addr)
        if s is not None:
            return s
        if addr[0] == "unix":
            # same-host fast path: ("unix", path) from _fast_addr
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.connect_timeout_s)
            try:
                s.connect(addr[1])
            except OSError:
                s.close()
                raise
        else:
            s = socket.create_connection(addr, timeout=self.connect_timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self.io_timeout_s)
        socks[1][addr] = s
        return s

    def _fast_addr(self, addr: Tuple[str, int]):
        """The address to actually dial: the server-advertised same-host
        Unix socket when one is known to exist, else ``addr`` itself. The
        logical TCP address stays the key for wire/caps/incarnation state
        either way — the UDS is a different door into the same server."""
        with self._caps_lock:
            path = self._uds_paths.get(addr)
        return ("unix", path) if path else addr

    def _drop_sock(self, addr: Optional[Tuple[str, int]] = None) -> None:
        addr = addr or self._seed
        socks = getattr(self._local, "pid_socks", None)
        if socks is not None:
            s = socks[1].pop(addr, None)
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def _route(self, op: str, args: Dict[str, Any]) -> Tuple[str, int]:
        """The address that owns this request: the owning shard when a
        shard map is known and the op names an experiment, else the seed
        (pan-shard ops like list_experiments/snapshot fan out there)."""
        with self._caps_lock:
            ring, addrs = self._ring, self._shard_addrs
        if ring is None:
            return self._seed
        exp = experiment_of(op, args)
        if exp is None:
            return self._seed
        return addrs.get(ring.owner(exp), self._seed)

    def _wire_for(self, addr: Tuple[str, int]) -> str:
        """The codec to speak to ``addr``: v2 only when that address's own
        ping advertised it (and it isn't strike-blocked)."""
        if self.wire != "auto":
            return "v1"
        with self._caps_lock:
            return self._addr_wire.get(addr, "v1")

    def _negotiate(self, s: socket.socket, addr: Tuple[str, int]) -> None:
        """One v1-JSON ping on this socket to learn the peer's wire (and
        UDS path). Runs once per previously-unseen address — the seed
        negotiates through the normal ping flow, this covers direct-to-
        shard connections that would otherwise never get pinged."""
        send_msg(s, {"op": "ping", "args": {}, "req": uuid.uuid4().hex})
        reply = recv_msg(s)
        if reply is None:
            raise ConnectionError("coordinator closed during negotiation")
        if reply.get("ok"):
            # transport facts only: negotiation must not rewrite op caps
            # or routing (those belong to the explicit ping flow — a
            # pinned-caps client stays pinned)
            with self._caps_lock:
                self._absorb_transport(addr, reply["result"])
        else:
            with self._caps_lock:
                self._addr_wire.setdefault(addr, "v1")

    def _wire_strike(self, addr: Tuple[str, int]) -> None:
        """A v2 frame was sent but no reply came back. One old JSON-only
        hop between us and the v2-capable endpoint (a router mid-rolling-
        upgrade relaying to a new shard) produces exactly this signature
        on every attempt — after three in a row, stop speaking v2 to this
        address instead of looping binary-send/connection-drop forever."""
        with self._caps_lock:
            n = self._v2_strikes.get(addr, 0) + 1
            self._v2_strikes[addr] = n
            if n >= 3 and addr not in self._wire_blocked:
                self._wire_blocked.add(addr)
                self._addr_wire[addr] = "v1"
                log.warning(
                    "wire v2 to %s:%s failed %d times in a row with no "
                    "reply; forcing JSON for this address (old relay in "
                    "the path?)", addr[0], addr[1], n)

    def _exchange(self, msg: Dict[str, Any],
                  addr: Tuple[str, int]) -> Dict[str, Any]:
        """Send one message to ``addr`` with the reconnect-retry loop; the
        request id inside ``msg`` is reused by every retry, so the reply
        cache keeps non-idempotent ops exactly-once across drops."""
        deadline = time.monotonic() + self.reconnect_window_s
        attempt = 0
        delay = 0.0
        while True:
            real = self._fast_addr(addr)
            wire = "v1"
            sent_ok = False
            try:
                s = self._sock(real)
                if self.wire == "auto" and msg.get("op") != "ping":
                    with self._caps_lock:
                        known = addr in self._addr_wire
                    if not known:
                        self._negotiate(s, addr)
                wire = self._wire_for(addr)
                payload = None
                if wire == "v2":
                    try:
                        key = experiment_of(msg.get("op"),
                                            msg.get("args") or {})
                        payload = encode_request_v2(msg, key or "")
                    except ProtocolError:
                        # this one message msgpack can't carry (e.g. an
                        # int beyond 64 bits): fall back to JSON for the
                        # frame; the server replies in kind
                        wire = "v1"
                if payload is None:
                    payload = encode_msg(msg)
                send_payload(s, payload)
                sent_ok = True
                raw = recv_payload(s)
                if raw is None:
                    raise ConnectionError("coordinator closed the connection")
                with self._io_lock:
                    self.bytes_sent += len(payload) + 4
                    self.bytes_recv += len(raw) + 4
                reply = decode_payload(raw)
                if wire == "v2":
                    with self._caps_lock:
                        self._v2_strikes.pop(addr, None)
                break
            except (ConnectionError, BrokenPipeError, OSError,
                    ProtocolError) as err:  # incl. a frame cut by shutdown
                self._drop_sock(real)
                if real != addr:
                    # the UDS door failed — stop preferring it; the
                    # immediate retry dials TCP (the path may be stale
                    # after a server restart, while TCP srv is fine)
                    with self._caps_lock:
                        self._uds_paths.pop(addr, None)
                if wire == "v2" and sent_ok:
                    self._wire_strike(addr)
                attempt += 1
                if attempt >= 2:
                    if time.monotonic() >= deadline:
                        raise CoordUnavailableError(
                            f"coordinator {addr[0]}:{addr[1]} "
                            f"unreachable for {self.reconnect_window_s:.0f}s"
                            f" ({type(err).__name__}: {err})"
                        ) from err
                    # coordinator down; wait out the restart — jittered so
                    # a whole pod's reconnects don't land as one herd
                    delay = decorrelated_jitter(delay)
                    time.sleep(delay)
                    if addr != self._seed and not getattr(
                            self._local, "rerouting", False):
                        # the owning shard may be GONE for good (failover
                        # shrank the map): re-learn routing from the seed
                        # and follow the new owner instead of dialing a
                        # dead address for the whole window
                        self._local.rerouting = True
                        try:
                            self.ping()
                        except Exception:
                            log.debug("reroute ping failed", exc_info=True)
                        finally:
                            self._local.rerouting = False
                        new_addr = self._route(msg.get("op"),
                                               msg.get("args") or {})
                        if new_addr != addr:
                            log.info("rerouting %s from %s to %s after "
                                     "map refresh", msg.get("op"), addr,
                                     new_addr)
                            addr = new_addr
        if attempt and msg.get("op") != "ping":
            # we reconnected at least once: resume the session (fresh caps,
            # and reservation re-assertion if the server incarnation
            # changed). After the reply — the retry itself was already
            # answered exactly-once by the (possibly rebuilt) reply cache.
            self._after_reconnect(addr)
        return reply

    def _call(self, op: str, **args: Any) -> Any:
        # one id per logical call, shared by the retry: the server dedups on
        # it, so "executed but reply lost" cannot double-execute the op
        msg = {"op": op, "args": args, "req": uuid.uuid4().hex}
        # Migrating = the owning shard fenced this experiment for a live
        # hand-off; the fence lifts (→ success on the new owner, or
        # WrongShardError pointing there) within the migration window, so
        # wait it out rather than failing a healthy pod
        deadline = time.monotonic() + max(5.0, self.reconnect_window_s)
        misses = 0
        delay = 0.0
        while True:
            reply = self._exchange(msg, self._route(op, args))
            if reply["ok"]:
                return reply["result"]
            err = reply["error"]
            if err == "WrongShardError" and misses < 2:
                # stale routing table: the shard map changed under us
                # (hand-off commit, shard added/removed across a restart
                # or rolling upgrade). Re-learn the map from the seed and
                # retry — the reused request id keeps the correctly-routed
                # retry exactly-once.
                misses += 1
            elif err == "Migrating" and time.monotonic() < deadline:
                delay = decorrelated_jitter(delay)
                time.sleep(delay)
            else:
                break
            try:
                self.ping()
            except Exception:
                log.debug("shard-map refresh ping failed", exc_info=True)
        exc = _ERRORS.get(reply["error"], CoordRPCError)
        raise exc(reply["msg"])

    def _absorb_transport(self, addr: Tuple[str, int],
                          r: Dict[str, Any]) -> None:
        """Record the per-address transport facts from a ping reply: the
        wire codec and the UDS door. Caller holds ``_caps_lock``. These
        apply per address (each shard speaks for itself), unlike caps /
        routing which stay seed-only and ping-flow-only."""
        caps = tuple(r.get("caps") or ())
        if ("wire_v2" in caps and HAVE_WIRE_V2
                and addr not in self._wire_blocked):
            self._addr_wire[addr] = "v2"
        else:
            self._addr_wire[addr] = "v1"
        path = r.get("uds_path")
        if path and os.path.exists(path):
            self._uds_paths[addr] = path
        else:
            self._uds_paths.pop(addr, None)

    def _absorb_ping(self, addr: Tuple[str, int], r: Dict[str, Any]) -> None:
        """Record what a ping of ``addr`` taught us. Only the seed's reply
        rewrites caps + shard map (a shard's own ping also carries them,
        but the seed stays the single source of truth for routing)."""
        with self._caps_lock:
            if r.get("incarnation"):
                self._incarnations[addr] = r["incarnation"]
            self._absorb_transport(addr, r)
            if addr != self._seed:
                return
            self._caps = tuple(r.get("caps") or ())
            if r.get("incarnation"):
                self._incarnation = r["incarnation"]
            smap = r.get("shard_map")
            if smap and SHARD_MAP_CAP in self._caps:
                if map_version(smap) >= self._map_version:
                    table = RoutingTable(smap)
                    self._shard_map = smap
                    self._ring = table
                    self._shard_addrs = table.addrs
                    self._map_version = table.version
                # else: stale reply from before a hand-off commit —
                # keep the newer routing (monotonic adoption)
            else:
                # a seed that stopped advertising the cap (rolled back to
                # a single-process server) un-teaches the map: degrade to
                # direct seed mode rather than routing into the void
                self._shard_map = None
                self._ring = None
                self._shard_addrs = {}
                self._map_version = -1

    def ping(self) -> Dict[str, Any]:
        r = self._call("ping")
        self._absorb_ping(self._seed, r)
        return r

    # -- session resumption ------------------------------------------------
    def _track(self, experiment: str, trial_id: str, worker: str) -> None:
        with self._live_lock:
            self._live[(experiment, trial_id)] = worker

    def _untrack(self, experiment: str, trial_id: str) -> None:
        with self._live_lock:
            self._live.pop((experiment, trial_id), None)

    def _after_reconnect(self, addr: Optional[Tuple[str, int]] = None) -> None:
        """The client half of crash recovery, run after any reconnect.

        Re-handshake: re-ping the address we reconnected to (a restarted
        coordinator may be a different build; a seed re-ping also
        refreshes caps + shard map). If the ping's ``incarnation``
        differs from the one we knew FOR THAT ADDRESS, this was a real
        restart — re-assert every reservation we hold with a heartbeat so
        the recovered server's stale sweep sees live workers, and drop
        the ones the new server no longer honors. (Heartbeats route by
        experiment, so under a shard map each lands on its owner; the
        extra beats to shards that never restarted are no-ops.) Guarded
        per-thread against reentry (the resumption RPCs themselves go
        through ``_call``/``_exchange``) and best-effort: resumption must
        never turn a successful retry into an error.
        """
        addr = addr or self._seed
        if getattr(self._local, "resuming", False):
            return
        self._local.resuming = True
        try:
            with self._caps_lock:
                prev = self._incarnations.get(addr)
                if prev is None and addr == self._seed:
                    prev = self._incarnation
                if addr == self._seed:
                    self._caps = None  # force the re-handshake ping
            try:
                reply = self._exchange(
                    {"op": "ping", "args": {}, "req": uuid.uuid4().hex},
                    addr,
                )
                if not reply["ok"]:
                    return
                r = reply["result"]
                self._absorb_ping(addr, r)
            except Exception:
                return  # still flapping; the next call retries again
            inc = r.get("incarnation")
            if prev is None or inc is None or inc == prev:
                return  # same server (or one too old to say) — no restart
            log.info("coordinator restarted (incarnation %s → %s); "
                     "re-asserting %d reservation(s)",
                     prev[:8], inc[:8], len(self._live))
            with self._live_lock:
                held = dict(self._live)
            for (exp, tid), worker in held.items():
                try:
                    hb = self._call("heartbeat", experiment=exp,
                                    trial_id=tid, worker=worker)
                    ours = bool(hb["ours"])
                except Exception:
                    continue  # keep it tracked; retried on the next beat
                if not ours:
                    self._untrack(exp, tid)
                    log.warning(
                        "reservation of %s/%s was not recovered by the "
                        "restarted coordinator (released or lost)",
                        exp, tid,
                    )
        finally:
            self._local.resuming = False

    def _has_cap(self, cap: str) -> bool:
        """Does the server advertise ``cap``? Probes with one ping on first
        use; a pre-caps server (no "caps" in its ping reply) reports
        nothing, and callers then rely on per-op "unknown op" degradation
        for anything they still optimistically try."""
        # snapshot under the declared guard: clients are shared across
        # worker threads, and ping()/degradation rewrite the tuple
        with self._caps_lock:
            caps = self._caps
        if caps is None:
            try:
                self.ping()
            except CoordRPCError:
                with self._caps_lock:
                    self._caps = ()
            with self._caps_lock:
                caps = self._caps
        return cap in (caps or ())

    # -- experiment docs ---------------------------------------------------
    def create_experiment(self, config: Dict[str, Any]) -> None:
        self._call("create_experiment", config=config)

    def load_experiment(self, name: str) -> Optional[Dict[str, Any]]:
        return self._call("load_experiment", name=name)

    def update_experiment(self, name: str, patch: Dict[str, Any]) -> None:
        self._call("update_experiment", name=name, patch=patch)

    def list_experiments(self) -> List[str]:
        return self._call("list_experiments")

    def delete_experiment(self, name: str) -> bool:
        return bool(self._call("delete_experiment", name=name))

    def tenant_stats(
            self, include_experiments: bool = False) -> Dict[str, Any]:
        """Multi-tenant service stats: per-tenant produce accounting and
        fleet residency; with ``include_experiments``, per-experiment
        status counts (evicted experiments answered from their O(1)
        stub index — this call never hydrates). Against a sharded seed
        the router fans the op out and merges per-shard accounting."""
        return self._call("tenant_stats",
                          include_experiments=bool(include_experiments))

    # -- trials ------------------------------------------------------------
    def register(self, trial: Trial) -> None:
        self._call("register", trial=trial.to_dict())

    def reserve(self, experiment: str, worker: str) -> Optional[Trial]:
        doc = self._call("reserve", experiment=experiment, worker=worker)
        if doc:
            self._track(experiment, doc["id"], worker)
        return Trial.from_dict(doc) if doc else None

    def update_trial(
        self,
        trial: Trial,
        expected_status: Optional[str] = None,
        expected_worker: Optional[str] = None,
    ) -> bool:
        ok = self._call(
            "update_trial",
            trial=trial.to_dict(),
            expected_status=expected_status,
            expected_worker=expected_worker,
        )
        if trial.status != "reserved":
            # leaving reserved (terminal, requeued, suspended …) ends our
            # hold whether the CAS succeeded or someone else took it
            self._untrack(trial.experiment, trial.id)
        return ok

    def heartbeat(self, experiment: str, trial_id: str, worker: str) -> bool:
        r = self._call(
            "heartbeat", experiment=experiment, trial_id=trial_id, worker=worker
        )
        if not r["ours"]:
            self._untrack(experiment, trial_id)
        # a "stop" signal fails the heartbeat on purpose: the executor treats
        # it as a lost reservation and tears the trial down — this is how a
        # coordinator-side judge prunes a trial running anywhere on the pod
        return bool(r["ours"]) and r.get("signal") != "stop"

    def get(self, experiment: str, trial_id: str) -> Optional[Trial]:
        doc = self._call("get", experiment=experiment, trial_id=trial_id)
        return Trial.from_dict(doc) if doc else None

    def fetch(self, experiment: str, status=None) -> List[Trial]:
        if isinstance(status, tuple):
            status = list(status)
        docs = self._call("fetch", experiment=experiment, status=status)
        return [Trial.from_dict(d) for d in docs]

    def count(self, experiment: str, status=None) -> int:
        # server-side: the base default is len(self.fetch(...)), which
        # RPCs and deserializes EVERY trial document — and the workon
        # loop counts twice per cycle (is_done + the producer's budget)
        if isinstance(status, tuple):
            status = list(status)
        try:
            return int(self._call("count", experiment=experiment,
                                  status=status))
        except CoordRPCError as err:
            if "unknown op" not in str(err):
                raise
            # rolling upgrade: a pre-count coordinator — degrade to the
            # base fetch-and-len path rather than killing the workon loop
            return len(self.fetch(experiment, tuple(status)
                                  if isinstance(status, list) else status))

    def fetch_completed_since(self, experiment: str, cursor=None):
        # decentralized-producer workers against a coordinator: the
        # server's memory backend tracks completion order, so each cycle
        # ships only the NEW completions over the wire
        try:
            r = self._call("fetch_completed_since", experiment=experiment,
                           cursor=cursor)
        except CoordRPCError as err:
            if "unknown op" not in str(err):
                raise
            # pre-cursor coordinator: full fetch, no incremental support
            return self.fetch(experiment, "completed"), None
        return [Trial.from_dict(d) for d in r["trials"]], r["cursor"]

    def release_stale(self, experiment: str, timeout_s: float) -> List[Trial]:
        # server-side so the sweep is atomic with every other mutation
        docs = self._call(
            "release_stale", experiment=experiment, timeout_s=timeout_s
        )
        return [Trial.from_dict(d) for d in docs]

    # -- hosted suggestion (north star: one fitted surrogate, on the
    # coordinator, for every worker) ---------------------------------------
    def produce(
        self,
        experiment: str,
        pool_size: Optional[int] = None,
        worker: Optional[str] = None,
    ) -> Dict[str, Any]:
        """One observe→suggest→register cycle on the coordinator's single
        hosted algorithm instance; returns {"registered": n, "algo_done",
        "coalesced"}. The server may group-commit concurrent produce calls
        (one combined cycle serves every request in the coalescing window);
        ``registered`` is then the combined total — a progress signal, not
        a per-caller count."""
        return self._call(
            "produce", experiment=experiment, pool_size=pool_size, worker=worker
        )

    def worker_cycle(
        self,
        experiment: str,
        worker: str,
        pool_size: Optional[int] = None,
        stale_timeout_s: Optional[float] = None,
        produce: bool = True,
        complete: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """One fused worker trial cycle in a single round-trip.

        Server-side this runs the deferred result push (``complete``: a
        ``{"trial": doc, "expected_status", "expected_worker"}`` payload
        applied with ``update_trial`` semantics before everything else) →
        sweep (when ``stale_timeout_s`` is given) → produce (through the
        shared coalescer — bit-identical suggestion stream to serial
        serving) → reserve → counts/doneness, and the reply carries
        everything the workon loop needs for the cycle: ``{"trial",
        "registered", "algo_done", "coalesced", "released", "signal",
        "suspend", "max_trials", "exp_algo_done", "counts",
        "completed_ok", "fused"}`` (``trial`` already a :class:`Trial`,
        ``fused`` added client-side: False means this reply was composed
        from serial RPCs against a server without the op, so per-reply
        fields like ``signal`` are best-effort there).

        Mirrors the ``count``/``fetch_completed_since`` rolling-upgrade
        doctrine: the op is taken only when the server advertises it (ping
        ``caps``) and still degrades per-op on "unknown op", so mixed-
        version pods keep working in both directions.

        ``complete`` may also carry ``{"trials": [docs...]}`` — the batched
        hunt's whole-pool push; the reply's ``completed_oks`` is positional.
        Against a server without the ``worker_cycle_multi`` cap the pushes
        degrade to per-trial ``update_trial`` RPCs before the cycle.
        """
        if (complete and complete.get("trials") is not None
                and not self._has_cap("worker_cycle_multi")):
            # old server: the multi-push leg would be silently dropped —
            # apply it as plain update_trial calls, then cycle without it
            oks = [
                bool(self._call(
                    "update_trial", trial=doc,
                    expected_status=complete.get("expected_status", "reserved"),
                    expected_worker=complete.get("expected_worker"),
                ))
                for doc in complete["trials"]
            ]
            for doc in complete["trials"]:
                self._untrack(experiment, doc["id"])
            r = self.worker_cycle(
                experiment, worker, pool_size=pool_size,
                stale_timeout_s=stale_timeout_s, produce=produce,
            )
            r["completed_oks"] = oks
            return r
        if self._has_cap("worker_cycle"):
            try:
                r = self._call(
                    "worker_cycle", experiment=experiment, worker=worker,
                    pool_size=pool_size, stale_timeout_s=stale_timeout_s,
                    produce=produce, complete=complete,
                )
            except CoordRPCError as err:
                if "unknown op" not in str(err):
                    raise
                # caps lied (e.g. a proxy answered the ping): degrade and
                # stop advertising to ourselves
                with self._caps_lock:
                    self._caps = tuple(
                        c for c in (self._caps or ()) if c != "worker_cycle"
                    )
            else:
                if complete and r.get("completed_oks") is not None:
                    for doc in (complete.get("trials")
                                or [complete["trial"]]):
                        # the push leg ended our hold either way
                        # (applied, or lost to another owner)
                        self._untrack(experiment, doc["id"])
                elif complete and r.get("completed_ok") is not None:
                    # pre-``completed_oks`` server: single-trial reply only
                    self._untrack(experiment, complete["trial"]["id"])
                r["trial"] = (
                    Trial.from_dict(r["trial"]) if r.get("trial") else None
                )
                if r["trial"] is not None:
                    self._track(experiment, r["trial"].id, worker)
                r["fused"] = True
                return r
        return self._worker_cycle_serial(
            experiment, worker, pool_size, stale_timeout_s, produce, complete
        )

    def _worker_cycle_serial(
        self,
        experiment: str,
        worker: str,
        pool_size: Optional[int],
        stale_timeout_s: Optional[float],
        produce: bool,
        complete: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """The same cycle as individual RPCs — the pre-``worker_cycle``
        wire sequence, packaged in the fused reply shape so the workon
        loop has exactly one coord-mode code path."""
        out: Dict[str, Any] = {
            "released": 0, "registered": 0, "algo_done": False,
            "coalesced": 0, "trial": None, "signal": None, "suspend": False,
            "completed_ok": None, "fused": False,
        }
        if complete:
            # the deferred result push, as its own RPC — same order the
            # fused cycle applies it (before sweep/produce/reserve)
            out["completed_ok"] = bool(self._call(
                "update_trial", trial=complete["trial"],
                expected_status=complete.get("expected_status", "reserved"),
                expected_worker=complete.get("expected_worker"),
            ))
        if stale_timeout_s is not None:
            out["released"] = len(
                self.release_stale(experiment, float(stale_timeout_s))
            )
        if produce:
            pres = self.produce(experiment, pool_size=pool_size, worker=worker)
            out["registered"] = pres["registered"]
            out["algo_done"] = bool(pres.get("algo_done"))
            out["coalesced"] = pres.get("coalesced", 0)
        t = self.reserve(experiment, worker)
        out["trial"] = t
        if t is not None:
            out["suspend"] = self.should_suspend(experiment, t)
        doc = self.load_experiment(experiment)
        if doc is None:
            raise KeyError(f"experiment {experiment!r} not found")
        out["max_trials"] = doc.get("max_trials")
        out["exp_algo_done"] = bool(doc.get("algo_done"))
        out["counts"] = {
            s: self.count(experiment, s)
            for s in ("new", "reserved", "completed")
        }
        return out

    def judge(
        self, experiment: str, trial: Trial, partial: List[Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        """Per-trial early-stop decision from the hosted algorithm."""
        return self._call(
            "judge", experiment=experiment, trial=trial.to_dict(), partial=partial
        )

    def should_suspend(self, experiment: str, trial: Trial) -> bool:
        """Suspension decision from the hosted algorithm."""
        return bool(self._call(
            "should_suspend", experiment=experiment, trial=trial.to_dict()
        ))

    # -- control plane -----------------------------------------------------
    def set_signal(self, experiment: str, trial_id: str, signal: str) -> None:
        """Pod-global control message, e.g. ``"stop"`` to prune a trial."""
        self._call(
            "set_signal", experiment=experiment, trial_id=trial_id, signal=signal
        )

    def snapshot(self, path: Optional[str] = None) -> str:
        return self._call("snapshot", path=path)
