"""CoordServer — the single-writer ledger service (port of
``metaopt_tpu/coord/server.py``, single process).

Instead of N workers racing on atomic document ops, one process owns a
:class:`~metaopt_tpu_torch.ledger.backends.LedgerBackend` and serializes every
mutation — per experiment, not globally — while workers connect with
:class:`~metaopt_tpu_torch.coord.client_backend.CoordLedgerClient`.

Beyond plain CRUD forwarding the server owns these pod-level duties:

- **Pacemaker sweep**: a background thread re-frees ``reserved`` trials whose
  heartbeat lapsed (dead worker / preempted host) — failure detection.
- **Snapshots**: periodic backend-agnostic dumps of every experiment +
  trial doc (+ control signals) to one JSON file; ``restore()`` reloads it,
  and algorithm state is rebuilt upstream by observe-replay over completed
  trials — checkpoint/resume without a database.
- **Control signals**: ``set_signal(exp, trial_id, "stop")`` makes that
  trial's next ``heartbeat`` answer False, which every executor treats as a
  lost reservation and tears the trial down. This is the pod-global
  early-stop broadcast path.
- **Hosted suggestion** (the surrogate fit on the coordinator's device):
  the ``produce`` op runs one observe→suggest→register
  cycle against a SINGLE algorithm instance the coordinator owns per
  experiment, so N workers share one fitted surrogate instead of re-fitting
  N divergent copies; ``judge`` forwards per-trial early-stop decisions to
  the same instance. Reconstructed by observe-replay after a restart —
  hosted-algorithm state needs no extra persistence beyond the ledger.
  Concurrent ``produce`` calls group-commit: requests landing within the
  ``produce_coalesce_ms`` window share ONE observe→suggest→register cycle
  whose suggest width is the combined request, served from a single fused
  launch (see :class:`_ProduceCoalescer`). The hosted algorithms run on
  ``CoordServer(device=...)``, ``cuda`` unless the caller says otherwise:
  without CUDA the constructor raises, it never hosts on the CPU by itself.

The RPC plane itself is built for many workers against one coordinator:

- **Per-experiment locking** (:class:`_ShardedLedger`): each mutation
  serializes only against its own experiment; the read ops (``fetch`` /
  ``count`` / ``fetch_completed_since`` / ``get``) take no server lock at
  all and ride the backend's own fine-grained locking, so observers never
  queue behind a writer's event-log append or reply bookkeeping.
- **Preserialized replies**: hot read replies are JSON-encoded ONCE per
  ledger commit (a per-experiment mutation counter keys the cache) and
  served as raw bytes to every observer at the same cursor — N workers
  observing one experiment cost one encode, not N.
- **Fused worker cycles**: the ``worker_cycle`` op runs a whole worker
  trial cycle (stale sweep → produce → reserve → counts/doneness) in one
  round-trip — see :meth:`CoordServer._worker_cycle`.
- **Pipelined connections**: each connection's replies are written by a
  dedicated sender thread, so the next request is decoded and dispatched
  while the previous (possibly MB-sized fetch) reply drains to the socket.
- **Write-ahead log** (:mod:`metaopt_tpu_torch.coord.wal`): every acknowledged
  mutation (and the reply-cache entry that makes its retry exactly-once)
  is group-commit fsynced to a WAL *before* the reply leaves the sender
  thread, so a crash loses nothing a client was told succeeded. Recovery
  is ``restore(snapshot) + replay(WAL tail)``; snapshots embed the WAL
  position they reflect and compact the log behind them. Enabled whenever
  a ``snapshot_path`` is configured (log lives at ``<snapshot>.wal``) or
  an explicit ``wal_path`` is given.

Sharded serving (:mod:`metaopt_tpu_torch.coord.shards`): a server given
``shard_id`` / ``shard_map`` is ONE shard of a consistent-hash map. It
advertises the map on ``ping``, answers ``WrongShardError`` for
experiments it does not own, and serves the hand-off admin plane
(``handoff_prepare``, ``handoff_apply``, ``handoff_abort``,
``shard_map_update``) that :mod:`metaopt_tpu_torch.coord.handoff` drives.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import queue
import signal as _signal_mod
import socket
import sys as _sys
import threading
import uuid
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple, Union

from metaopt_tpu_torch.coord.protocol import (
    HAVE_WIRE_V2,
    ProtocolError,
    decode_payload,
    encode_msg,
    encode_reply_v2,
    payload_is_v2,
    recv_payload,
    send_payload,
)
from metaopt_tpu_torch.coord.shards import (
    RoutingTable,
    experiment_of,
    map_version,
)
from metaopt_tpu_torch.coord.fuser import SuggestFuser
from metaopt_tpu_torch.coord.tenancy import FairProduceScheduler
from metaopt_tpu_torch.coord.wal import WriteAheadLog, fsync_dir, read_records
from metaopt_tpu_torch.executor.faults import faults
from metaopt_tpu_torch.ledger.backends import (
    AdmissionError,
    DuplicateExperimentError,
    LedgerBackend,
    MemoryLedger,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.utils import fsjournal as fsj
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

log = logging.getLogger(__name__)

#: optional ops this build serves, advertised in the ``ping`` reply so a
#: client can pick its fast paths up front instead of probe-by-error
CAPS = ("count", "fetch_completed_since", "worker_cycle",
        # worker_cycle's complete leg accepts {"trials": [...]} — the
        # batched hunt pushes a whole evaluated pool in one cycle
        "worker_cycle_multi",
        # multi-tenant service plane (coord/tenancy.py): per-tenant
        # produce accounting + evicted-experiment status counts
        "tenant_stats") + (
            # binary wire format v2 (coord/protocol.py): advertised only
            # when the codec is importable, so a msgpack-less build simply
            # never negotiates it and every peer stays on JSON
            ("wire_v2",) if HAVE_WIRE_V2 else ())


class _ShardedLedger:
    """Proxy that takes the server's PER-EXPERIMENT lock around each op.

    Successor of the PR-1 ``_LockedLedger`` (one global RLock): ops on
    different experiments no longer serialize against each other, and the
    hosted Producer's expensive algorithm fit still runs outside every
    ledger lock — each of its individual ledger accesses re-enters only
    its own experiment's lock. Mutating calls bump the server's
    per-experiment mutation counter, which is what invalidates the
    preserialized-reply cache.
    """

    #: methods whose experiment rides on a Trial argument
    _TRIAL_ARG = frozenset({"register", "update_trial"})
    #: pure reads served WITHOUT any server lock: each is a single
    #: internally-atomic backend call (MemoryLedger holds its own RLock,
    #: FileLedger its per-experiment flock), so an observer gets a
    #: consistent per-call snapshot without queueing behind a writer
    _LOCK_FREE = frozenset({
        "get", "fetch", "count", "fetch_completed_since",
        "load_experiment", "list_experiments", "export_docs",
    })
    #: methods after which cached encoded replies must not be served.
    #: ``heartbeat`` is deliberately absent: it only refreshes a liveness
    #: timestamp, and counting it would bust the reply cache dozens of
    #: times a second for data no consumer treats as authoritative (the
    #: stale sweep reads live docs, never cached replies).
    _MUTATORS = frozenset({
        "create_experiment", "update_experiment", "delete_experiment",
        "register", "reserve", "update_trial", "release_stale",
    })

    def __init__(self, inner: LedgerBackend, server: "CoordServer") -> None:
        self._inner = inner
        self._server = server

    def _exp_of(self, method: str, args, kwargs) -> Optional[str]:
        if method in self._TRIAL_ARG:
            t = args[0] if args else kwargs.get("trial")
            return getattr(t, "experiment", None)
        if method == "create_experiment":
            cfg = (args[0] if args else kwargs.get("config")) or {}
            return cfg.get("name")
        if args and isinstance(args[0], str):
            return args[0]
        return kwargs.get("experiment") or kwargs.get("name")

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        if name in self._LOCK_FREE:
            return attr

        def locked(*args: Any, **kwargs: Any) -> Any:
            exp = self._exp_of(name, args, kwargs)
            with self._server._exp_lock(exp):
                out = attr(*args, **kwargs)
                if name in self._MUTATORS:
                    self._server._mutated(exp)
                    # journal while still under the experiment lock so WAL
                    # order matches commit order per experiment; append is
                    # buffer-only (no I/O) — the fsync happens at the
                    # durability barrier in the connection's sender thread
                    self._server._journal_mutation(name, args, kwargs, out)
                return out

        return locked


class _ProduceCoalescer:
    """Group-commit for concurrent ``produce`` RPCs on one hosted algorithm.

    N workers that call ``produce`` within one bounded window
    (``produce_coalesce_ms``) are served by a SINGLE
    observe→suggest→register cycle whose suggest width is the combined
    request. The surrogate batches that combined width into one launch
    (TPE packs pad_pow2(ceil(want / pool_w)) pools into the same call —
    see ``TPE._launch_ei``), so the fixed launch + readback cost
    is paid once per window instead of once per worker.

    Replay determinism: the combined suggest consumes exactly the PRNG pool
    positions the member requests would have consumed served one after the
    other (pool p of a batched launch draws from the generator seeded by
    (seed, n_obs, count + p) — bit-identical to p sequential launches), so
    coalescing changes latency, never the suggestion stream. The
    ``worker_cycle`` op funnels its produce leg through the same coalescer,
    so fused cycles inherit the identical guarantee.

    Every member's reply reports the TOTAL the combined cycle registered
    plus the member count (``coalesced``). Worker loops use ``registered``
    only as a progress/idle signal (worker/loop.py), so reporting the group
    total to each member is benign — and honest: those trials ARE now
    available for every member to reserve.

    The leader (first request of a window) sleeps the window out, closes
    the batch, and runs the cycle under the per-experiment producer lock;
    latecomers open the next batch and pipeline behind it. ``window_s=0``
    degrades to plain per-request serving (still one-cycle-per-request,
    just without the wait).
    """

    class _Batch:
        __slots__ = ("sizes", "workers", "done", "result", "error", "closed")

        def __init__(self) -> None:
            self.sizes: list = []
            self.workers: list = []
            self.done = threading.Event()
            self.result: Optional[Dict[str, Any]] = None
            self.error: Optional[BaseException] = None
            self.closed = False

    def __init__(self, producer, plock: threading.Lock, window_s: float,
                 on_cycle=None, clock: Optional[Clock] = None) -> None:
        self.producer = producer
        self.plock = plock
        self.window_s = window_s
        self.on_cycle = on_cycle
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self._guard = threading.Lock()
        self._open: Optional["_ProduceCoalescer._Batch"] = None

    def produce(self, pool_size: Optional[int],
                worker: Optional[str] = None) -> Dict[str, Any]:
        with self._guard:
            b = self._open
            leader = b is None or b.closed
            if leader:
                b = self._open = self._Batch()
            b.sizes.append(pool_size)
            b.workers.append(worker)
        if not leader:
            b.done.wait()
        else:
            if self.window_s > 0:
                self.clock.sleep(self.window_s)
            with self._guard:
                b.closed = True
                if self._open is b:
                    self._open = None
            try:
                default = self.producer.experiment.pool_size
                want = sum(int(ps or default) for ps in b.sizes)
                with self.plock:
                    n = self.producer.produce(want)
                b.result = {
                    "registered": n,
                    "algo_done": bool(self.producer.algorithm.is_done),
                    "coalesced": len(b.sizes),
                }
                if self.on_cycle is not None:
                    self.on_cycle(b)
            except BaseException as e:
                b.error = e
            finally:
                b.done.set()
        if b.error is not None:
            raise b.error
        assert b.result is not None
        return dict(b.result)


class CoordServer:
    """Serve a ledger backend over TCP; one thread per client connection.

    Every mutating ledger op runs under its experiment's lock (the
    single-writer guarantee, sharded); reads take no server lock.
    ``port=0`` binds an ephemeral port (tests); ``.address`` reports it.
    """

    def __init__(
        self,
        inner: Optional[LedgerBackend] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_path: Optional[str] = None,
        snapshot_interval_s: float = 30.0,
        snapshot_incremental: bool = True,
        stale_timeout_s: Optional[float] = None,
        sweep_interval_s: float = 5.0,
        event_log_path: Optional[str] = None,
        host_algorithms: bool = True,
        produce_coalesce_ms: float = 3.0,
        suggest_prefetch_depth: int = 1,
        wal_path: Optional[str] = None,
        wal: bool = True,
        wal_fsync: bool = True,
        wal_group_ms: float = 1.0,
        shard_id: Optional[str] = None,
        shard_map: Optional[Dict[str, Any]] = None,
        uds_path: Optional[str] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        tenant_quotas: Optional[Dict[str, int]] = None,
        fair_window_s: float = 0.5,
        fair_burst: int = 2,
        max_experiments: Optional[int] = None,
        max_experiments_per_tenant: Optional[int] = None,
        evict_idle_s: Optional[float] = None,
        max_resident: Optional[int] = None,
        evict_dir: Optional[str] = None,
        archive_segment_rows: Optional[int] = None,
        archive_completed: bool = True,
        fuse_suggest: bool = False,
        fuse_bucket_max: int = 32,
        fuse_interval_s: float = 0.05,
        clock: Optional[Clock] = None,
        device: Any = None,
    ) -> None:
        #: injectable time source (utils/clock.py). All wall stamps
        #: (snapshot/event/heartbeat times) and all in-process intervals
        #: (housekeeping cadence, evict idle tracking, drain deadlines)
        #: flow through it; the scale simulator passes a VirtualClock so
        #: a simulated hour of heartbeats costs microseconds. When an
        #: explicit clock is given it is propagated to the inner backend
        #: (heartbeat stamps + stale sweep share the same timeline).
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        #: the device every hosted algorithm whose constructor takes one
        #: (TPE, BOHB, MOTPE, GP-BO) runs on; kept out of the stored
        #: algorithm configuration. Resolved here so a server on a machine
        #: without CUDA raises at once instead of hosting on the CPU.
        self.device = None
        if host_algorithms:
            from metaopt_tpu_torch.utils.device import resolve_device

            self.device = resolve_device(device)
        if inner is not None:
            self.inner = inner
        else:
            kw: Dict[str, Any] = {"archive_completed": archive_completed}
            if archive_segment_rows is not None:
                kw["archive_segment_rows"] = int(archive_segment_rows)
            self.inner = MemoryLedger(**kw)
        if clock is not None:
            self.inner.clock = self.clock
        self._bind = (host, port)
        #: same-host fast path: also listen on this Unix domain socket and
        #: advertise it in the ping reply — pod-local clients that can
        #: reach the path switch to it automatically (loopback TCP pays
        #: per-segment protocol work UDS doesn't). The TCP listener stays;
        #: UDS is an additional door into the same dispatch.
        self.uds_path = uds_path
        self._uds_sock: Optional[socket.socket] = None
        self.snapshot_path = snapshot_path
        self.snapshot_interval_s = snapshot_interval_s
        #: incremental snapshots (v2 manifest): sealed archive segments
        #: are written to ``<snapshot>.segments/<seg_id>.json`` exactly
        #: once and referenced by id; only dirty experiments and the
        #: mutable head reserialize per snapshot — O(dirty), not O(total).
        #: Engages only when the inner backend exposes the archive API
        #: (MemoryLedger); other backends keep the full v1 dump.
        self.snapshot_incremental = bool(snapshot_incremental)
        self.stale_timeout_s = stale_timeout_s
        self.sweep_interval_s = sweep_interval_s
        self.event_log_path = event_log_path
        #: WAL location: explicit ``wal_path`` wins; otherwise derived as
        #: ``<snapshot_path>.wal`` whenever snapshots are configured (so
        #: ``serve --snapshot X`` is durable with no extra flag). A
        #: bare in-memory server (tests/benchmarks with neither path) runs
        #: without a WAL, exactly as before. ``wal=False`` force-disables.
        if wal and wal_path is None and snapshot_path:
            wal_path = snapshot_path + ".wal"
        self.wal_path = wal_path if wal else None
        self.wal_fsync = wal_fsync
        #: group-commit sleep window (ms). 0 = no sleep: the fsync
        #: duration itself is the batching window (while the leader fsyncs
        #: one batch, the next accumulates) — same leader/latecomer
        #: doctrine as _ProduceCoalescer. The 1ms default measured best at
        #: 32-worker fan-in (bigger batches, fewer GIL-bound wakeup
        #: rounds) while staying under single-client latency noise.
        self.wal_group_ms = wal_group_ms
        self._wal: Optional[WriteAheadLog] = None
        #: server identity, minted per construction and reported in the
        #: ping reply: a client that reconnects and sees a DIFFERENT
        #: incarnation knows it crossed a restart and re-asserts its live
        #: reservations / re-learns caps (session resumption)
        self._incarnation = uuid.uuid4().hex
        #: sharded serving (coord/shards.py): when this server
        #: is ONE shard of a consistent-hash map, it advertises the map in
        #: its ping reply (cap "shard_map", so new clients route directly)
        #: and rejects experiment-named ops it does not own with
        #: WrongShardError — a routing-table-stale client refreshes the
        #: map and retries instead of silently splitting an experiment's
        #: state across two shards' ledgers/WALs. Both None (the default)
        #: = the ordinary unsharded server, wire-identical to before.
        self.shard_id = shard_id
        self.shard_map = shard_map
        self._ring = (RoutingTable(shard_map)
                      if shard_id is not None and shard_map is not None
                      else None)
        #: live hand-off state (coord/handoff.py), all under _map_cv:
        #: ``_migrating`` fences experiments mid-migration (their ops get
        #: a retryable ``Migrating`` reply), ``_exp_inflight`` counts
        #: dispatches in flight per experiment so handoff_prepare can
        #: drain them, and the routing pair (shard_map, _ring) is swapped
        #: wholesale when a bumped map version is adopted. The cv is also
        #: the drain signal — never held across dispatch or I/O.
        self._map_cv = threading.Condition()
        self._migrating: Dict[str, str] = {}
        self._exp_inflight: Dict[str, int] = {}

        #: global fallback lock — restore() and ops that name no experiment
        self._lock = threading.RLock()
        #: per-experiment RLocks, created on demand and never popped (a
        #: popped lock under a blocked waiter forks its identity — same
        #: doctrine as the file ledger's persistent lock files)
        self._exp_locks: Dict[str, threading.RLock] = {}
        self._exp_locks_guard = threading.Lock()
        self._snap_lock = threading.Lock()  # serializes snapshot file writes
        #: experiment → (mutation counter, manifest section) — the O(dirty)
        #: core of incremental snapshots: a clean experiment's section is
        #: reused verbatim, skipping its capture AND reserialization
        self._snap_sections: Dict[str, Tuple[int, Dict[str, Any]]] = {}
        #: segment id → file name, for segments already durably written
        #: under ``<snapshot>.segments/`` (written once, content immutable)
        self._seg_on_disk: Dict[str, str] = {}
        #: deferred-snapshot request (post-delete durability): the serving
        #: thread sets it, the housekeeping loop snapshots — a delete no
        #: longer pays a whole snapshot on the request path when the WAL
        #: already journals it durably
        self._snap_soon = threading.Event()
        self._signals: Dict[Tuple[str, str], str] = {}  # (exp, trial_id) → signal
        self._sig_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._conns: set = set()  # live client connections (for stop())
        self._threads: list[threading.Thread] = []
        self._stopping = threading.Event()
        self._op_counter = itertools.count(1)  # next() is GIL-atomic
        self._ops = 0
        #: reply cache keyed by client request id — answers retries of calls
        #: whose reply was lost to a dropped connection without re-executing
        #: them (exactly-once semantics for reserve, worker_cycle & co.)
        self._replies: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._replies_cap = 4096
        self._replies_lock = threading.Lock()
        #: request id → experiment, maintained in step with _replies: a
        #: hand-off ships the moving experiment's cached replies to the
        #: new owner (and an eviction carries them in its file) so an
        #: exactly-once retry that straddles either is still answered
        #: from cache, not re-executed
        self._reply_exps: Dict[str, str] = {}
        #: worker_cycle requests mid-execution, keyed by request id: a retry
        #: arriving while the original still runs must wait for ITS reply,
        #: not re-run the embedded reserve (the sharded locks no longer
        #: serialize the whole dispatch, so the serial path's
        #: lock-then-cache idiom doesn't cover a multi-op cycle)
        self._inflight: Dict[str, threading.Event] = {}
        self._inflight_lock = threading.Lock()
        #: per-dispatch-thread state: ``reply_journaled`` is True while the
        #: op being dispatched carries a retry id (its reply record will be
        #: journaled), letting _journal_mutation skip records the reply
        #: already embeds
        self._tl = threading.local()
        #: per-experiment ledger mutation counter — the preserialized-reply
        #: cache key. Bumped by _ShardedLedger under the experiment's lock.
        self._mut: Dict[str, int] = {}
        #: (op, experiment, args-key) → (mut counter, encoded reply bytes).
        #: N observers at the same cursor are served the SAME bytes; any
        #: commit to the experiment bumps the counter and the next read
        #: re-executes + re-encodes exactly once.
        self._enc_cache: "OrderedDict[tuple, Tuple[int, bytes]]" = OrderedDict()
        self._enc_cap = 128
        self._enc_lock = threading.Lock()
        self._enc_hits = 0
        #: every ledger access (dispatch AND hosted producers) goes through
        #: the sharded proxy so locking + cache invalidation can't diverge
        self.ledger = _ShardedLedger(self.inner, self)
        self.host_algorithms = host_algorithms
        #: experiment → (Producer, per-experiment lock). One algorithm
        #: instance shared by every worker that delegates suggestion here;
        #: the per-experiment producer lock serializes produce/judge on it
        #: WITHOUT holding any ledger lock across an algorithm fit (which
        #: would stall heartbeats long enough for the stale sweep to
        #: reclaim live reservations) — the Producer's ledger ops re-enter
        #: the experiment's lock individually via :class:`_ShardedLedger`.
        self._producers: Dict[str, Any] = {}
        self._producers_guard = threading.Lock()
        #: group-commit window for concurrent produce RPCs (0 disables):
        #: requests arriving within this window share ONE
        #: observe→suggest→register cycle — see _ProduceCoalescer
        self.produce_coalesce_ms = produce_coalesce_ms
        self._coalescers: Dict[str, _ProduceCoalescer] = {}
        #: speculative suggest-ahead depth applied to hosted algorithms
        #: that mix in SuggestAhead (tpe/gp_bo/cmaes): depth N keeps N
        #: prepared pools banked so the produce leg of a fused
        #: worker_cycle answers from memory instead of blocking on
        #: kernel compute; 1 = the historical refill-when-stale default
        self.suggest_prefetch_depth = max(1, int(suggest_prefetch_depth))

        # -- multi-tenant service plane ------------------------------------
        #: admission-control limits for create_experiment; None = unlimited
        self.max_experiments = max_experiments
        self.max_experiments_per_tenant = max_experiments_per_tenant
        #: weighted deficit round-robin over the produce leg of
        #: worker_cycle — see coord/tenancy.py. Always constructed (cheap);
        #: with a single active tenant every request is admitted, so the
        #: historical single-tenant benches/tests are untouched.
        self._sched = FairProduceScheduler(
            weights=tenant_weights, quotas=tenant_quotas,
            window_s=fair_window_s, burst=fair_burst,
        )
        #: guards the scheduler + the experiment→tenant map
        self._tenant_lock = threading.Lock()
        self._tenant_of: Dict[str, str] = {}
        #: lazy hydration/eviction: idle experiments' full state (doc,
        #: trial docs, signals, reply-cache entries, hosted algorithm
        #: state_dict) moves to a crash-atomic per-experiment file; what
        #: stays resident is this stub map (doc + O(1) status counts, so
        #: ``count``/``load_experiment`` answer WITHOUT hydrating).
        #: Journaled as WAL ``evict``/``hydrate`` records — kill -9
        #: anywhere in the cycle loses nothing.
        self.evict_idle_s = evict_idle_s
        self.max_resident = max_resident
        # derive the evict dir from the snapshot location ONLY when an
        # eviction policy is actually configured — a plain snapshotting
        # server must keep the historical no-fence request path
        if evict_dir is None and snapshot_path and (
                evict_idle_s is not None or max_resident is not None):
            evict_dir = os.path.join(
                os.path.dirname(os.path.abspath(snapshot_path)), "evict")
        self.evict_dir = evict_dir
        self._evict_lock = threading.Lock()
        self._evicted: Dict[str, Dict[str, Any]] = {}
        self._exp_last_touch: Dict[str, float] = {}
        self._evictions = 0
        self._hydrations = 0

        #: fleet-fused suggest plane (coord/fuser.py): one demand sweep
        #: per tick collapses the resident experiments' acquisition
        #: launches into O(buckets) batched fleet launches that feed each
        #: algorithm's prefetch pool off the reply path. Opt-in
        #: (``fuse_suggest=True`` / ``serve --fuse-suggest``); when
        #: off, nothing changes — the fuser is never constructed.
        self.fuse_interval_s = float(fuse_interval_s)
        self._fuser = (SuggestFuser(self, bucket_max=fuse_bucket_max)
                       if fuse_suggest else None)

        #: housekeeping cadence stamps (monotonic — the historical code
        #: kept these in wall time, which raced NTP steps). Initialized
        #: here, not in the loop, so ``housekeeping_step()`` can be
        #: driven directly on a virtual schedule with no loop thread.
        self._last_sweep = self.clock.monotonic()
        self._last_snap = self.clock.monotonic()

    def _exp_lock(self, name: Optional[str]) -> threading.RLock:
        if not name:
            return self._lock
        with self._exp_locks_guard:
            lk = self._exp_locks.get(name)
            if lk is None:
                lk = self._exp_locks[name] = threading.RLock()
            return lk

    # mtpu: holds(EXP)
    def _mutated(self, name: Optional[str]) -> None:
        """Record a commit against ``name`` (caller holds its exp lock)."""
        if name:
            self._mut[name] = self._mut.get(name, 0) + 1

    # -- write-ahead log ---------------------------------------------------
    def _journal_mutation(self, method: str, args, kwargs, out) -> None:
        """Append the redo record for one committed ledger mutation.

        Physical, not logical: nondeterministic ops (``reserve`` picks a
        trial, ``release_stale`` depends on wall clock) journal their
        RESULTING document states as ``put_trial`` upserts, so replay is
        deterministic and idempotent regardless of how many times the same
        tail is applied over a snapshot that may already reflect it.
        Caller holds the experiment lock; append is buffer-only.
        """
        wal = self._wal
        if wal is None:
            return
        if method == "register":
            t = args[0] if args else kwargs.get("trial")
            wal.append({"op": "put_trial", "trial": t.to_dict()})
        elif method == "update_trial":
            if out:
                t = args[0] if args else kwargs.get("trial")
                wal.append({"op": "put_trial", "trial": t.to_dict()})
        elif method == "reserve":
            # when the request carries a retry id, the journaled REPLY
            # record already embeds the reserved doc and replay upserts it
            # from there (_apply_wal_record) — journaling it here too would
            # double the reserve's WAL bytes on the hottest path
            if out is not None and not getattr(
                    self._tl, "reply_journaled", False):
                wal.append({"op": "put_trial", "trial": out.to_dict()})
        elif method == "release_stale":
            for t in out:
                wal.append({"op": "put_trial", "trial": t.to_dict()})
        elif method == "create_experiment":
            cfg = args[0] if args else kwargs.get("config")
            wal.append({"op": "create_experiment", "config": cfg})
        elif method == "update_experiment":
            name = args[0] if args else kwargs.get("name")
            patch = args[1] if len(args) > 1 else kwargs.get("patch")
            wal.append({"op": "update_experiment", "name": name,
                        "patch": patch})
        elif method == "delete_experiment":
            if out:
                name = args[0] if args else kwargs.get("name")
                wal.append({"op": "delete_experiment", "name": name})

    def _journal_reply(self, req: Optional[str], reply: Dict[str, Any],
                       exp: Optional[str] = None) -> None:
        """Journal a reply-cache entry so a retry that straddles a restart
        is still answered from cache (exactly-once across crashes). The
        ``exp`` tag lets a hand-off attribute the record to the moving
        experiment (:func:`metaopt_tpu_torch.coord.wal.record_experiment`)."""
        if req and self._wal is not None:
            rec: Dict[str, Any] = {"op": "reply", "req": req, "reply": reply}
            if exp is not None:
                rec["exp"] = exp
            self._wal.append(rec)

    def _cache_reply(self, req: str, reply: Dict[str, Any],
                     exp: Optional[str] = None) -> None:
        """Store one reply-cache entry, evicting oldest past the cap and
        keeping the experiment attribution map in step."""
        with self._replies_lock:
            self._replies[req] = reply
            if exp is not None:
                self._reply_exps[req] = exp
            while len(self._replies) > self._replies_cap:
                old, _ = self._replies.popitem(last=False)
                self._reply_exps.pop(old, None)

    #: ops whose reply must not leave before their WAL records are durable.
    #: The hand-off admin plane (handoff_* / shard_map_update) journals
    #: inside its handlers, not in _dispatch, so it lives here too.
    _DURABLE_OPS = frozenset(
        {"create_experiment", "update_experiment", "delete_experiment",
         "register", "reserve", "update_trial", "release_stale",
         "set_signal", "worker_cycle", "produce",
         "handoff_prepare", "handoff_apply", "handoff_abort",
         "shard_map_update"}
    )

    def _barrier_seq(self, op: Optional[str]) -> int:
        """The WAL seq a reply to ``op`` must wait on before it is sent
        (0 = no barrier). Read AFTER dispatch returns, so it covers every
        record the op appended; it may also cover a concurrent op's
        records, which only widens the group-commit batch."""
        wal = self._wal
        if wal is None or op not in self._DURABLE_OPS:
            return 0
        return wal.appended_seq

    def _apply_wal_record(self, rec: Dict[str, Any]) -> Optional[str]:
        """Replay one record against the INNER backend (no re-journaling,
        no sharded locks — recovery runs single-threaded before serving).
        Returns the experiment it touched, if any."""
        op = rec.get("op")
        if op == "put_trial":
            t = Trial.from_dict(rec["trial"])
            self.inner.put_trial(t)
            if t.status in ("completed", "broken", "interrupted"):
                # mirror the live update_trial path: terminal states
                # retire any pending control signal
                with self._sig_lock:
                    self._signals.pop((t.experiment, t.id), None)
            return t.experiment
        if op == "create_experiment":
            try:
                self.inner.create_experiment(rec["config"])
            except DuplicateExperimentError:
                pass  # snapshot already has it — replay is idempotent
            return (rec["config"] or {}).get("name")
        if op == "update_experiment":
            try:
                self.inner.update_experiment(rec["name"], rec["patch"])
            except KeyError:
                pass  # deleted later in the log
            return rec["name"]
        if op == "delete_experiment":
            self.inner.delete_experiment(rec["name"])
            with self._sig_lock:
                self._signals = {k: v for k, v in self._signals.items()
                                 if k[0] != rec["name"]}
            return rec["name"]
        if op == "set_signal":
            with self._sig_lock:
                self._signals[(rec["experiment"], rec["trial_id"])] = (
                    rec["signal"])
            return rec["experiment"]
        if op == "shard_map":
            # map adoption marker: a respawned shard restarts with the
            # STALE map its original spawn argv carried — replaying the
            # journaled adoption re-learns every hand-off/failover commit
            # it acknowledged before dying
            new_map = rec.get("map")
            with self._map_cv:
                if map_version(new_map) > map_version(self.shard_map):
                    self.shard_map = new_map
                    if self.shard_id is not None:
                        self._ring = RoutingTable(new_map)
            return None
        if op == "handoff_fence":
            # re-arm a migration fence that was live at the crash: the
            # captured state may already have shipped, so a recovered
            # source must NOT accept new writes for this experiment
            # until the orchestrator commits or aborts. Harmless when
            # the commit's shard_map record follows later in the log —
            # ownership is checked before the fence at dispatch.
            with self._map_cv:
                self._migrating[rec["experiment"]] = rec.get("dest", "?")
            return None
        if op == "handoff_abort":
            with self._map_cv:
                self._migrating.pop(rec["experiment"], None)
            return None
        if op == "evict":
            # the record is durable BEFORE the live path drops any state,
            # so replaying it over a snapshot that still holds the docs
            # re-executes the drop: delete + stub, never a loss
            name = rec["experiment"]
            if isinstance(self.inner, MemoryLedger):
                self.inner.delete_experiment(name)
            with self._sig_lock:
                self._signals = {k: v for k, v in self._signals.items()
                                 if k[0] != name}
            with self._evict_lock:
                self._evicted[name] = {
                    "path": rec.get("path"),
                    "counts": rec.get("counts") or {},
                    "tenant": rec.get("tenant", "default"),
                    "experiment": rec.get("doc"),
                }
            return None
        if op == "hydrate":
            # re-apply the evict file (frozen at evict time); mutations
            # that followed the live hydration replay after this record
            # and upsert over it. Algorithm state is NOT restored here —
            # crash recovery rebuilds it by observe-replay, the doctrine
            # every other recovery path already follows.
            name = rec["experiment"]
            with self._evict_lock:
                stub = self._evicted.pop(name, None)
            path = rec.get("path") or (stub or {}).get("path")
            if path and os.path.exists(path):
                try:
                    with open(path) as f:
                        state = json.load(f)
                except (OSError, json.JSONDecodeError):
                    log.exception("evict file %s unreadable at replay", path)
                    return None
                if (self.inner.load_experiment(name) is None
                        and state.get("experiment")):
                    self.inner.create_experiment(state["experiment"])
                have = {t.id for t in self.inner.fetch(name)}
                for doc in state.get("trials") or []:
                    if doc["id"] not in have:
                        self.inner.put_trial(Trial.from_dict(doc))
                with self._sig_lock:
                    for sig in state.get("signals") or []:
                        self._signals[(name, sig["trial_id"])] = sig["signal"]
                for r in state.get("replies") or []:
                    self._cache_reply(r["req"], r["reply"], exp=name)
            return name
        if op == "reply":
            reply = rec["reply"]
            self._cache_reply(rec["req"], reply, exp=rec.get("exp"))
            # a reply record may be the ONLY journal of a reserve's
            # resulting doc (_journal_mutation skips the put_trial when
            # the reply embeds it) — re-apply the embedded doc here
            res = reply.get("result") if reply.get("ok") else None
            doc = None
            if isinstance(res, dict):
                if isinstance(res.get("trial"), dict):
                    doc = res["trial"]  # worker_cycle reply
                elif "params" in res and "experiment" in res and "id" in res:
                    doc = res  # plain reserve reply
            if doc is not None:
                t = Trial.from_dict(doc)
                self.inner.put_trial(t)
                return t.experiment
            return None
        log.warning("unknown WAL record op %r skipped (newer writer?)", op)
        return None

    def _recover(self) -> None:
        """Crash recovery: ``restore(snapshot) + replay(WAL tail)``.

        The snapshot embeds the WAL seq it reflects (``wal_seq``); records
        at or below it are skipped, the tail is replayed in order (torn
        trailing bytes were already truncated by :func:`read_records`),
        and the journaled reply cache is rebuilt so in-flight retries are
        answered, not re-executed. Reserved trials get their heartbeat
        refreshed to *now* — a healthy worker mid-trial must get a full
        ``stale_timeout_s`` to re-assert before the sweep frees its trial.
        After a non-trivial replay a fresh snapshot is taken immediately,
        which also compacts the log — recovery time stays bounded by one
        snapshot interval of traffic, not the server's lifetime.
        """
        snap_seq = 0
        restored = False
        if self.snapshot_path and os.path.exists(self.snapshot_path):
            state = self.restore(self.snapshot_path)
            snap_seq = int(state.get("wal_seq", 0) or 0)
            restored = True
        replayed = 0
        torn = 0
        last_seq = snap_seq
        if self.wal_path and os.path.exists(self.wal_path):
            records, torn = read_records(self.wal_path)
            with self._lock:
                for rec in records:
                    seq = int(rec.get("seq", 0))
                    last_seq = max(last_seq, seq)
                    if seq <= snap_seq:
                        # pre-bound records exist on disk only in the
                        # window between a snapshot publish and its
                        # compaction; the snapshot carries no reply
                        # cache, so the reply entry must still be
                        # installed (exactly-once across a crash in
                        # that window). The embedded doc is skipped:
                        # the snapshot's copy can only be newer.
                        if rec.get("op") == "reply":
                            self._cache_reply(rec["req"], rec["reply"],
                                              exp=rec.get("exp"))
                        continue
                    try:
                        touched = self._apply_wal_record(rec)
                    except Exception:
                        log.exception("WAL replay failed on record %s",
                                      rec.get("op"))
                    else:
                        replayed += 1
                        if touched:
                            with self._exp_lock(touched):
                                self._mutated(touched)
            if replayed or torn:
                log.info("WAL %s: replayed %d records over snapshot seq %d"
                         "%s", self.wal_path, replayed, snap_seq,
                         f" ({torn} torn bytes truncated)" if torn else "")
        if self.wal_path:
            self._wal = WriteAheadLog(
                self.wal_path, fsync=self.wal_fsync,
                group_window_s=self.wal_group_ms / 1000.0,
                clock=self.clock,
            ).open(next_seq=last_seq + 1)
        if restored or replayed:
            # recovery grace: restored heartbeats are as old as the crash;
            # without a refresh the first sweep would free trials whose
            # workers are alive and about to re-assert their sessions
            now_refreshed = 0
            for name in self.inner.list_experiments():
                for t in self.inner.fetch(name, "reserved"):
                    if t.worker and self.inner.heartbeat(name, t.id,
                                                         t.worker):
                        now_refreshed += 1
            if now_refreshed:
                log.info("recovery grace: %d reservations re-aged to now",
                         now_refreshed)
        if (replayed or torn) and self.snapshot_path:
            self.snapshot(self.snapshot_path)  # also compacts the WAL
        # rebuild the tenant map (resident docs + evicted stubs) and stamp
        # every survivor as just-touched — the idle TTL must measure from
        # the restart, not evict the whole fleet on the first sweep
        now = self.clock.monotonic()
        tenants: Dict[str, str] = {}
        for name in self.inner.list_experiments():
            doc = self.inner.load_experiment(name) or {}
            tenants[name] = str(doc.get("tenant") or "default")
        with self._evict_lock:
            stubs = {name: str(stub.get("tenant") or "default")
                     for name, stub in self._evicted.items()}
            for name in tenants:
                if name not in self._evicted:
                    self._exp_last_touch[name] = now
        with self._tenant_lock:
            self._tenant_of.update(stubs)
            self._tenant_of.update(tenants)

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        assert self._sock is not None, "server not started"
        return self._sock.getsockname()[:2]

    def start(self) -> "CoordServer":
        self._recover()
        if self._wal is not None:
            # a WAL-enabled server interleaves fsync barriers with
            # dispatch: at the default 5 ms GIL slice the leader returning
            # from an fsync can wait a whole slice behind a dispatch
            # thread before it may release the batch's waiters, which
            # multiplies the measured group-commit cost several-fold at
            # 32-worker fan-in. 1 ms bounds that dead time; restored on
            # stop() for in-process (test/bench) hosts.
            self._prev_switchinterval = _sys.getswitchinterval()
            if self._prev_switchinterval > 0.001:
                _sys.setswitchinterval(0.001)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._bind)
        self._sock.listen(128)
        self._spawn(self._accept_loop, "coord-accept")
        if self.uds_path:
            uds = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                os.unlink(self.uds_path)  # stale socket from a dead server
            except OSError:
                pass
            uds.bind(self.uds_path)
            uds.listen(128)
            self._uds_sock = uds
            self._spawn(lambda: self._accept_loop(uds), "coord-accept-uds")
            log.info("coordinator also listening on uds://%s", self.uds_path)
        if (self.stale_timeout_s is not None or self.snapshot_path
                or (self._evict_enabled
                    and (self.evict_idle_s is not None
                         or self.max_resident is not None))):
            self._spawn(self._housekeeping_loop, "coord-sweep")
        if self._fuser is not None and self.host_algorithms:
            self._spawn(self._fuser_loop, "coord-fuser")
        log.info("coordinator listening on %s:%d", *self.address)
        return self

    def stop(self) -> None:
        """Orderly shutdown: stop serving FIRST, snapshot LAST.

        Ordering is a durability invariant: once the final snapshot is
        taken, no further write may be acknowledged — a client whose write
        landed after the snapshot but got an ok reply would see that write
        silently vanish on restore. Closing the listen socket and every
        live connection before snapshotting forces in-flight clients onto
        their reconnect/retry path, where the successor server answers.
        """
        self._stopping.set()
        if self._uds_sock is not None:
            # same shutdown-before-close doctrine as the TCP listener
            try:
                self._uds_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._uds_sock.close()
            except OSError:
                pass
            self._uds_sock = None
            try:
                os.unlink(self.uds_path)
            except OSError:
                pass
        if self._sock is not None:
            # shutdown() BEFORE close(): closing an fd another thread is
            # blocked in accept() on does NOT wake that thread on Linux —
            # it stays parked forever (and the freed fd number can be
            # reused under it). shutdown() forces accept to return
            # EINVAL immediately.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self.snapshot_path:
            self.snapshot(self.snapshot_path)
        if self._wal is not None:
            # after the final snapshot (which compacted it): flush any
            # remaining buffered records and release the handle
            self._wal.close()
            self._wal = None
            prev = getattr(self, "_prev_switchinterval", None)
            if prev is not None and prev > 0.001:
                _sys.setswitchinterval(prev)
        for t in self._threads:
            t.join(timeout=2)

    def __enter__(self) -> "CoordServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    # -- background duties -------------------------------------------------
    def _housekeeping_loop(self) -> None:
        self._last_snap = self.clock.monotonic()
        self._last_sweep = self.clock.monotonic()
        while not self._stopping.wait(min(self.sweep_interval_s, 1.0)):
            self.housekeeping_step()

    def _fuser_loop(self) -> None:
        """Fused-suggest demand sweep at ``fuse_interval_s`` cadence.

        A tick with no demand (every resident pool fresh) costs one lock
        sweep and launches nothing, so a short interval is cheap; a tick
        with demand replaces O(resident) per-experiment launches with
        O(buckets) fleet launches.
        """
        while not self._stopping.wait(self.fuse_interval_s):
            try:
                self._fuser.tick()
            except Exception:
                log.exception("fused suggest tick failed")

    def housekeeping_step(self) -> None:
        """One housekeeping beat: stale sweep, due snapshot, evict sweep.

        Factored out of the loop so the scale simulator can drive the
        exact production duties on a virtual schedule (no loop thread).
        Cadence is measured on ``clock.monotonic()`` — the historical
        wall-clock stamps made the sweep/snapshot cadence jump with NTP
        steps while ``_stopping.wait`` ticked monotonically.
        """
        now = self.clock.monotonic()
        if (
            self.stale_timeout_s is not None
            and now - self._last_sweep >= self.sweep_interval_s
        ):
            for name in self.inner.list_experiments():
                released = self.ledger.release_stale(
                    name, self.stale_timeout_s
                )
                for t in released:
                    self._event("release_stale", name, trial=t.id)
            self._last_sweep = self.clock.monotonic()
        if self.snapshot_path and (
            self._snap_soon.is_set()
            or now - self._last_snap >= self.snapshot_interval_s
        ):
            # _snap_soon: a serving thread handed off post-delete
            # durability work rather than paying for a snapshot on
            # the request path (the WAL already journals the delete)
            self.snapshot(self.snapshot_path)
            self._last_snap = self.clock.monotonic()
        if self._evict_enabled and (self.evict_idle_s is not None
                                    or self.max_resident is not None):
            try:
                self.evict_sweep()
            except Exception:
                log.exception("evict sweep failed")
        if self._fuser is not None and self.host_algorithms:
            # hosts that call housekeeping_step directly run no loop
            # threads — give them the fused sweep on the same beat
            try:
                self._fuser.tick()
            except Exception:
                log.exception("fused suggest tick failed")

    # -- snapshot / restore ------------------------------------------------
    def snapshot(self, path: str) -> None:
        """Durable state dump; atomic replace so a crash mid-write never
        corrupts the previous snapshot.

        Two formats behind one entry point:

        * **v1 (full)** — backend-agnostic: every experiment's full doc set
          in one JSON file. Used when ``snapshot_incremental`` is off or
          the inner backend has no columnar archive.
        * **v2 (incremental)** — sealed archive segments are written to
          ``<path>.segments/<seg_id>.json`` exactly once (their content is
          immutable) and referenced from the manifest; a clean experiment's
          manifest section is reused from ``_snap_sections`` without
          re-capturing or re-serializing anything. Snapshot cost is
          O(dirty experiments + new segments), not O(total trials).

        ``_snap_lock`` covers capture AND write: the housekeeping thread and
        ``stop()`` may snapshot concurrently, and interleaving their
        capture/write phases could commit an older capture last. Capture is
        per-experiment-consistent (each experiment exported under its own
        lock) rather than a global point-in-time — restore() merges by doc
        id, so cross-experiment skew is benign, and writers on OTHER
        experiments are never stalled by a multi-MB capture.
        """
        with self._snap_lock:
            # any deferred-snapshot request up to this point is satisfied
            # by the capture below; deletes landing mid-capture are
            # journaled in the WAL tail and re-request via _snap_soon
            self._snap_soon.clear()
            if (self.snapshot_incremental
                    and hasattr(self.inner, "archive_segment_refs")):
                self._snapshot_v2_locked(path)
            else:
                self._snapshot_v1_locked(path)

    # mtpu: holds(_snap_lock)
    def _snapshot_v1_locked(self, path: str) -> None:
        wal = self._wal
        # read BEFORE capture: any record <= this seq was appended
        # under its experiment's lock before capture takes that lock,
        # so the capture reflects it; records > it stay in the WAL
        # tail and replay idempotently over this snapshot
        wal_seq = wal.appended_seq if wal is not None else 0
        experiments: Dict[str, Any] = {}
        trials: Dict[str, Any] = {}
        for name in self.inner.list_experiments():
            with self._exp_lock(name):
                experiments[name] = self.inner.load_experiment(name)
                trials[name] = self.inner.export_docs(name)
        state = {
            "version": 1,
            "ts": self.clock.time(),
            "experiments": experiments,
            "trials": trials,
            "wal_seq": wal_seq,
        }
        self._snapshot_globals(state, experiments)
        self._snapshot_commit(path, state, wal, wal_seq)

    # mtpu: holds(_snap_lock)
    def _snapshot_v2_locked(self, path: str) -> None:
        wal = self._wal
        # read BEFORE capture, same ordering argument as v1
        wal_seq = wal.appended_seq if wal is not None else 0
        seg_dir = path + ".segments"
        sections: Dict[str, Dict[str, Any]] = {}
        for name in self.inner.list_experiments():
            with self._exp_lock(name):
                mut = self._mut.get(name, 0)
                cached = self._snap_sections.get(name)
                if cached is not None and cached[0] == mut:
                    # clean since its last capture: reuse the section —
                    # this is the O(dirty) payoff
                    sections[name] = cached[1]
                    continue
                config = self.inner.load_experiment(name)
                docs = self.inner.export_mutable_docs(name)
                refs = self.inner.archive_segment_refs(name)
            # segment persistence cycles export-then-write per segment:
            # export under the experiment lock (a concurrent
            # delete_experiment cannot drop the archive between listing
            # refs and exporting rows), the fsync-heavy file write outside
            # it — and only one segment's docs are ever resident at a
            # time, so the first snapshot after a restart stays flat-RSS
            # even at millions of archived rows
            missing = False
            for ref in refs:
                if self._seg_on_disk.get(ref["seg"]) is not None:
                    continue
                with self._exp_lock(name):
                    try:
                        seg_docs = self.inner.export_archive_segment(
                            name, ref["seg"])
                    except KeyError:
                        # the experiment (or its archive) was deleted
                        # mid-capture: drop the whole section — the delete
                        # is in the WAL tail / re-requests via _snap_soon
                        missing = True
                        break
                # one-time I/O per sealed segment, never repeated once
                # durable (_seg_on_disk dedups across snapshots)
                self._persist_segment(seg_dir, name, ref["seg"], seg_docs)
            if missing:
                continue
            seg_entries = [{
                "seg": ref["seg"],
                "file": self._seg_on_disk[ref["seg"]],
                "rows": ref["rows"],
                "dead": ref["dead"],
            } for ref in refs]
            section = {"experiment": config, "docs": docs,
                       "segments": seg_entries}
            sections[name] = section
            # cached only HERE, after every referenced segment file is
            # durable — a reused section never points at a missing file
            self._snap_sections[name] = (mut, section)
        for stale in set(self._snap_sections) - set(sections):
            del self._snap_sections[stale]
        state = {
            "version": 2,
            "ts": self.clock.time(),
            "sections": sections,
            "wal_seq": wal_seq,
        }
        self._snapshot_globals(state, sections)
        self._snapshot_commit(path, state, wal, wal_seq)
        self._gc_segments(seg_dir, sections)

    # mtpu: holds(_snap_lock)
    def _persist_segment(self, seg_dir: str, name: str, seg_id: str,
                         docs: List[Dict[str, Any]]) -> str:
        """Write one sealed segment's rows (dead included — the manifest's
        ``dead`` list filters at restore, so revivals never force a
        rewrite) crash-atomically, once per segment id ever."""
        fname = seg_id + ".json"
        if self._seg_on_disk.get(seg_id) == fname:
            return fname
        os.makedirs(seg_dir, exist_ok=True)
        tmp = os.path.join(seg_dir, fname + ".tmp")
        final = os.path.join(seg_dir, fname)
        # written + fsynced BEFORE the rename publishes it (crash-atomic
        # doctrine)
        fsj.write_file(tmp, json.dumps(
            {"experiment": name, "seg": seg_id, "docs": docs}).encode())
        fsj.replace(tmp, final)
        fsync_dir(final)
        self._seg_on_disk[seg_id] = fname
        if faults.fire("crash_segment_seal"):
            # chaos: die with the segment file durable but no manifest
            # referencing it — recovery must come up on the previous
            # manifest + WAL, and the orphan file must be GC'd by a later
            # snapshot, never loaded
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        return fname

    def _snapshot_globals(self, state: Dict[str, Any],
                          resident: Dict[str, Any]) -> None:
        """Capture the non-ledger globals every snapshot format carries."""
        with self._sig_lock:
            state["signals"] = [
                {"experiment": e, "trial": t, "signal": s}
                for (e, t), s in self._signals.items()
            ]
        with self._map_cv:
            smap = self.shard_map
        with self._evict_lock:
            # compaction drops journaled evict records at or below
            # wal_seq — the snapshot must carry the stubs or a restart
            # forgets which experiments live in evict files. Stubs for
            # experiments captured resident above are skipped (a
            # non-memory backend keeps docs on disk through eviction).
            evicted = {n: dict(s) for n, s in self._evicted.items()
                       if n not in resident}
        if evicted:
            state["evicted"] = evicted
        if smap is not None:
            # compaction will drop any journaled shard_map adoption
            # record at or below wal_seq — the snapshot must carry the
            # adopted map or a restart falls back to its stale argv map
            state["shard_map"] = smap

    # mtpu: holds(_snap_lock)
    def _snapshot_commit(self, path: str, state: Dict[str, Any],
                         wal, wal_seq: int) -> None:
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = json.dumps(state).encode()
        if faults.fire("partial_snapshot"):
            # chaos: die mid-snapshot — a truncated tmp on disk,
            # the previous snapshot and the (un-compacted) WAL
            # intact. Recovery must ignore the torn tmp entirely.
            fsj.write_file(tmp, payload[: max(1, len(payload) // 2)])
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        # write + flush + fsync BEFORE the rename: os.replace orders the
        # metadata, not the data blocks — on power loss the rename
        # could land pointing at an unwritten file, destroying the
        # previous good snapshot too
        fsj.write_file(tmp, payload)
        if faults.fire("crash_manifest_commit"):
            # chaos: die with the tmp manifest fully durable but the
            # rename not yet issued — recovery must come up on the
            # PREVIOUS manifest plus the (un-compacted) WAL; newly
            # sealed segment files are unreferenced orphans until a
            # post-recovery snapshot collects them
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        fsj.replace(tmp, path)
        fsync_dir(path)
        if wal is not None:
            # everything <= wal_seq is now durably in the snapshot;
            # drop it so replay cost tracks one snapshot interval. The
            # rewrite runs under the compaction fence — compact() ignores
            # the calling thread's own fence, so this cannot self-deadlock.
            with wal.compaction_fence():
                wal.compact(wal_seq)

    # mtpu: holds(_snap_lock)
    def _gc_segments(self, seg_dir: str,
                     sections: Dict[str, Dict[str, Any]]) -> None:
        """Remove segment files the just-committed manifest does not
        reference. Runs strictly AFTER the manifest is durable: until
        then the old manifest may still need the old files."""
        referenced = {entry["file"] for sec in sections.values()
                      for entry in sec["segments"]}
        try:
            on_disk = os.listdir(seg_dir)
        except OSError:
            return
        for fname in on_disk:
            if fname in referenced:
                continue
            # deleted experiments' segments, pre-crash orphans from
            # crash_segment_seal / crash_manifest_commit windows, and
            # torn .tmp files all land here
            try:
                fsj.unlink(os.path.join(seg_dir, fname))
            except OSError:
                pass
        for seg_id, fname in list(self._seg_on_disk.items()):
            if fname not in referenced:
                del self._seg_on_disk[seg_id]

    def restore(self, path: str) -> Dict[str, Any]:
        """Merge a snapshot into the ledger; returns the loaded state dict
        (the recovery path reads ``wal_seq`` off it).

        Merge semantics are deliberately conservative: only experiments
        and trials MISSING from the ledger are created — an existing
        trial's status is never touched, so restoring a stale snapshot
        over live (or WAL-replayed) state cannot roll anything back.

        v2 (incremental) manifests are inflated to the v1 shape first:
        mutable docs plus each referenced segment file's live rows, the
        per-segment ``dead`` lists filtering revived rows out. The merge
        below then re-registers docs through the normal validated path —
        completed docs re-seal into the rebuilt archive as they arrive.
        """
        with open(path) as f:
            state = json.load(f)
        if int(state.get("version", 1)) >= 2:
            self._inflate_v2(path, state)
        with self._lock:
            existing = set(self.inner.list_experiments())
            for name, config in state["experiments"].items():
                if name not in existing and config is not None:
                    self.inner.create_experiment(config)
            for name, docs in state["trials"].items():
                have = {t.id for t in self.inner.fetch(name)}
                for doc in docs:
                    if doc["id"] not in have:
                        self.inner.register(Trial.from_dict(doc))
                with self._exp_lock(name):
                    self._mutated(name)
            with self._sig_lock:
                for sig in state.get("signals", []):
                    self._signals[(sig["experiment"], sig["trial"])] = (
                        sig["signal"])
            with self._evict_lock:
                for name, stub in (state.get("evicted") or {}).items():
                    # merge semantics match the doc path: resident (or
                    # already-stubbed) experiments are never overwritten
                    if name not in existing:
                        self._evicted.setdefault(name, stub)
            snap_map = state.get("shard_map")
            with self._map_cv:
                if map_version(snap_map) > map_version(self.shard_map):
                    self.shard_map = snap_map
                    if self.shard_id is not None:
                        self._ring = RoutingTable(snap_map)
        log.info("restored %d experiments from %s", len(state["experiments"]), path)
        return state

    def _inflate_v2(self, path: str, state: Dict[str, Any]) -> None:
        """Expand a v2 manifest in place to the v1 shape ``restore``
        merges: per-experiment config + full doc list. A missing or torn
        segment file loses only that segment's rows — the rest of the
        manifest still restores (and the WAL tail still replays)."""
        seg_dir = path + ".segments"
        experiments: Dict[str, Any] = {}
        trials: Dict[str, Any] = {}
        for name, sec in (state.get("sections") or {}).items():
            experiments[name] = sec.get("experiment")
            docs = list(sec.get("docs") or [])
            for entry in sec.get("segments") or []:
                fp = os.path.join(seg_dir, entry["file"])
                try:
                    with open(fp) as sf:
                        seg_state = json.load(sf)
                except (OSError, ValueError):
                    log.error(
                        "segment file %s unreadable; its rows are lost "
                        "to this restore", fp)
                    continue
                dead = set(entry.get("dead") or ())
                docs.extend(
                    d for i, d in enumerate(seg_state.get("docs") or [])
                    if i not in dead)
            trials[name] = docs
        state["experiments"] = experiments
        state["trials"] = trials

    # -- lazy hydration / eviction ------------------------------------------
    @property
    def _evict_enabled(self) -> bool:
        return self.evict_dir is not None

    #: ops answered from the resident stub's O(1) status-count index —
    #: they must NOT hydrate an evicted experiment (fleet-wide status
    #: sweeps read counts through these)
    _NO_HYDRATE_OPS = frozenset(
        {"count", "load_experiment", "list_experiments"})

    def _evict_file(self, name: str) -> str:
        assert self.evict_dir is not None
        return os.path.join(self.evict_dir,
                            name.replace(os.sep, "_") + ".json")

    def _produce_admit(self, name: str) -> bool:
        """Fair-scheduling gate on one produce leg (tenancy.py)."""
        with self._tenant_lock:
            tenant = self._tenant_of.get(name, "default")
            return self._sched.admit(tenant, now=self.clock.monotonic())

    def evict_sweep(self) -> int:
        """One eviction pass: idle-TTL victims first, then LRU victims
        down to the resident budget. Returns experiments evicted."""
        now = self.clock.monotonic()
        with self._evict_lock:
            touch = dict(self._exp_last_touch)
            already = set(self._evicted)
        resident = [n for n in self.inner.list_experiments()
                    if n not in already]
        victims = []
        if self.evict_idle_s is not None:
            victims = [n for n in resident
                       if now - touch.get(n, 0.0) >= self.evict_idle_s]
        if (self.max_resident is not None
                and len(resident) - len(victims) > self.max_resident):
            rest = sorted((n for n in resident if n not in set(victims)),
                          key=lambda n: touch.get(n, 0.0))
            need = len(resident) - len(victims) - self.max_resident
            victims.extend(rest[:need])
        evicted = 0
        for name in victims:
            if self._stopping.is_set():
                break
            if self.evict_experiment(name):
                evicted += 1
        return evicted

    def evict_experiment(self, name: str) -> bool:
        """Move one experiment's full state to its crash-atomic evict file,
        leaving only a stub (doc + status counts) resident.

        Fenced exactly like a live hand-off: new ops on the experiment get
        a retryable ``Migrating`` while in-flight ones drain, so the
        capture/drop below can never interleave with a dispatch. The evict
        record is fsynced BEFORE any state is dropped — kill -9 anywhere
        in the cycle recovers to either fully-resident or cleanly-evicted,
        never in between (chaos barriers ``crash_evict``).
        """
        if not self._evict_enabled:
            return False
        with self._map_cv:
            if name in self._migrating:
                return False
            self._migrating[name] = "<evict>"
            deadline = self.clock.monotonic() + 5.0
            while self._exp_inflight.get(name, 0) > 0:
                remaining = deadline - self.clock.monotonic()
                if remaining <= 0:
                    self._migrating.pop(name, None)
                    self._map_cv.notify_all()
                    return False
                self._map_cv.wait(timeout=min(0.05, remaining))
        try:
            return self._evict_fenced(name)
        finally:
            with self._map_cv:
                self._migrating.pop(name, None)
                self._map_cv.notify_all()

    def _evict_fenced(self, name: str) -> bool:
        """Capture + journal + drop, with the migration fence held."""
        with self._evict_lock:
            if name in self._evicted:
                return False
        # the hosted producer leaves memory with the experiment; its
        # algorithm state rides in the evict file so hydration restores
        # the surrogate bit-identically instead of re-fitting
        with self._producers_guard:
            entry = self._producers.pop(name, None)
            self._coalescers.pop(name, None)
        algo_state = None
        if entry is not None:
            producer, plock = entry
            with plock:
                try:
                    algo_state = {
                        "algo": producer.algorithm.state_dict(),
                        "completed_cursor": producer._completed_cursor,
                        "warm_started": producer._warm_started,
                        "algo_done": producer.algo_done,
                    }
                except Exception:
                    log.exception(
                        "algo state capture failed for %r; hydration "
                        "falls back to observe-replay", name)
        with self._exp_lock(name):
            doc = self.inner.load_experiment(name)
            if doc is None:
                return False
            docs = self.inner.export_docs(name)
        with self._sig_lock:
            signals = [{"trial_id": t, "signal": s}
                       for (e, t), s in self._signals.items() if e == name]
        with self._replies_lock:
            replies = [{"req": r, "reply": self._replies[r]}
                       for r, e in self._reply_exps.items()
                       if e == name and r in self._replies]
        counts: Dict[str, int] = {}
        for d in docs:
            counts[d["status"]] = counts.get(d["status"], 0) + 1
        with self._tenant_lock:
            tenant = self._tenant_of.get(name, "default")
        state = {"experiment": doc, "trials": docs, "signals": signals,
                 "replies": replies, "algo": algo_state, "counts": counts,
                 "tenant": tenant}
        path = self._evict_file(name)
        os.makedirs(self.evict_dir, exist_ok=True)
        tmp = path + ".tmp"
        # fsync BEFORE the rename — same crash-atomic doctrine as the
        # snapshot writer: the rename must never land on unwritten data
        fsj.write_file(tmp, json.dumps(state).encode())
        fsj.replace(tmp, path)
        fsync_dir(path)
        if faults.fire("crash_evict"):
            # chaos barrier 1: file durable, nothing journaled, nothing
            # dropped — recovery serves the experiment fully resident
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        wal = self._wal
        if wal is not None:
            # durable BEFORE the drop: replaying this record over a
            # snapshot that still holds the docs re-executes the drop
            wal.append({"op": "evict", "experiment": name, "path": path,
                        "counts": counts, "tenant": tenant, "doc": doc})
            wal.sync(wal.appended_seq)
        if faults.fire("crash_evict"):
            # chaos barrier 2: journaled durable, memory not yet dropped
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        with self._exp_lock(name):
            if isinstance(self.inner, MemoryLedger):
                # disk-backed inners (file/native) keep their docs — only
                # the in-memory plane (handles, producer, caches) drops
                self.inner.delete_experiment(name)
            self._mutated(name)
        release = getattr(self.inner, "release_handle", None)
        if release is not None:
            try:
                release(name)
            except Exception:
                log.exception("native handle release failed for %r", name)
        with self._sig_lock:
            self._signals = {k: v for k, v in self._signals.items()
                             if k[0] != name}
        with self._replies_lock:
            for req in [r for r, e in self._reply_exps.items()
                        if e == name]:
                self._reply_exps.pop(req, None)
                self._replies.pop(req, None)
        with self._evict_lock:
            self._evicted[name] = {"path": path, "counts": counts,
                                   "tenant": tenant, "experiment": doc}
            self._evictions += 1
            self._exp_last_touch.pop(name, None)
        self._event("evict", name, trials=len(docs))
        return True

    def hydrate_experiment(self, name: str) -> bool:
        """Restore one evicted experiment on first touch — bit-identical:
        trial docs, pending signals, reply-cache entries, and the hosted
        algorithm's ``state_dict`` all come back exactly as captured."""
        with self._exp_lock(name):
            with self._evict_lock:
                stub = self._evicted.get(name)
            if stub is None:
                return False
            path = stub.get("path") or self._evict_file(name)
            with open(path) as f:
                state = json.load(f)
            if self.inner.load_experiment(name) is None:
                self.inner.create_experiment(state["experiment"])
            have = {t.id for t in self.inner.fetch(name)}
            for doc in state.get("trials") or []:
                if doc["id"] not in have:
                    self.inner.put_trial(Trial.from_dict(doc))
            self._mutated(name)
        with self._sig_lock:
            for sig in state.get("signals") or []:
                self._signals[(name, sig["trial_id"])] = sig["signal"]
        for r in state.get("replies") or []:
            self._cache_reply(r["req"], r["reply"], exp=name)
        algo_state = state.get("algo")
        if algo_state and self.host_algorithms:
            try:
                producer, plock, _ = self._hosted_producer(name)
                with plock:
                    producer.algorithm.load_state_dict(algo_state["algo"])
                    producer._completed_cursor = algo_state.get(
                        "completed_cursor")
                    producer._warm_started = bool(
                        algo_state.get("warm_started"))
                    producer.algo_done = bool(algo_state.get("algo_done"))
            except Exception:
                log.exception("algo state restore failed for %r; "
                              "observe-replay will rebuild", name)
        if self._wal is not None:
            # buffer-only append: the touching op's sender barrier (or any
            # later mutation's) makes it durable before a dependent ack;
            # a crash before that replays back to still-evicted, and the
            # next touch re-hydrates from the same file
            self._wal.append({"op": "hydrate", "experiment": name,
                              "path": path})
        with self._evict_lock:
            self._evicted.pop(name, None)
            self._hydrations += 1
            self._exp_last_touch[name] = self.clock.monotonic()
        self._event("hydrate", name)
        return True

    def _tenant_stats(self, a: Dict[str, Any]) -> Dict[str, Any]:
        """The ``tenant_stats`` op: per-tenant produce accounting +
        fleet residency, computed WITHOUT hydrating anything. With
        ``include_experiments`` the reply adds per-experiment status
        counts (evicted ones answered from their stubs)."""
        with self._tenant_lock:
            sched = self._sched.stats()
            tenant_of = dict(self._tenant_of)
        with self._evict_lock:
            evicted = {n: dict(s) for n, s in self._evicted.items()}
            evictions, hydrations = self._evictions, self._hydrations
        tenants: Dict[str, Dict[str, Any]] = {}
        for name, tenant in tenant_of.items():
            d = tenants.setdefault(tenant, {"experiments": 0, "evicted": 0})
            d["experiments"] += 1
            if name in evicted:
                d["evicted"] += 1
        for tenant, s in sched.items():
            tenants.setdefault(
                tenant, {"experiments": 0, "evicted": 0}).update(s)
        for tenant, d in tenants.items():
            # configured weight surfaces even before any produce history
            d.setdefault("weight", self._sched.weight(tenant))
        # per-tenant suggest-plane health: aggregate each resident hosted
        # algorithm's SuggestAhead + fused counters by owning tenant (a
        # tenant whose hit rate sags is paying inline launches on its
        # reply path — the signal `tenants` renders)
        with self._producers_guard:
            prods = [(n, entry[0].algorithm)
                     for n, entry in self._producers.items()]
        for name, algo in prods:
            tenant = tenant_of.get(name, "default")
            d = tenants.setdefault(tenant, {"experiments": 0, "evicted": 0})
            tele = getattr(algo, "suggest_ahead_telemetry", None)
            if tele is not None:
                t = tele()
                d["prefetch_hits"] = (
                    d.get("prefetch_hits", 0) + t["prefetch_hits"])
                d["prefetch_misses"] = (
                    d.get("prefetch_misses", 0) + t["prefetch_misses"])
            at = getattr(algo, "telemetry", None)
            if at is not None:
                t = at()
                d["fused_commits"] = (
                    d.get("fused_commits", 0) + t.get("fused_commits", 0))
                d["fused_discards"] = (
                    d.get("fused_discards", 0) + t.get("fused_discards", 0))
        for d in tenants.values():
            served = d.get("prefetch_hits", 0) + d.get("prefetch_misses", 0)
            if served:
                d["suggest_hit_rate"] = round(
                    d.get("prefetch_hits", 0) / served, 4)
        out: Dict[str, Any] = {
            "tenants": tenants,
            "resident": max(0, len(tenant_of) - len(evicted)),
            "evicted": len(evicted),
            "evictions": evictions,
            "hydrations": hydrations,
        }
        if self._fuser is not None:
            out["fuser"] = self._fuser.telemetry()
        if a.get("include_experiments"):
            per: Dict[str, Any] = {}
            for name, tenant in tenant_of.items():
                stub = evicted.get(name)
                if stub is not None:
                    counts = dict(stub.get("counts") or {})
                else:
                    counts = {s: self.inner.count(name, s)
                              for s in ("new", "reserved", "completed")}
                    counts = {s: c for s, c in counts.items() if c}
                per[name] = {"tenant": tenant,
                             "evicted": stub is not None,
                             "counts": counts}
            out["experiments"] = per
        return out

    # -- event log ---------------------------------------------------------
    def _event(self, op: str, experiment: Optional[str], **extra: Any) -> None:
        if not self.event_log_path:
            return
        rec = {"ts": round(self.clock.time(), 4), "op": op,
               "experiment": experiment}
        rec.update(extra)
        try:
            with open(self.event_log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:  # observability must never take down the service
            log.exception("event log write failed")

    # -- request dispatch --------------------------------------------------
    def _accept_loop(self, sock: Optional[socket.socket] = None) -> None:
        sock = sock if sock is not None else self._sock
        assert sock is not None
        while not self._stopping.is_set():
            try:
                conn, _addr = sock.accept()
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="coord-conn",  # leak-attributable (tests/conftest.py)
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """Pipelined per-connection loop: a dedicated sender thread writes
        replies while this thread decodes and dispatches the NEXT request,
        so a client streaming pipelined requests overlaps its reply
        serialization with server-side work. Reply order is preserved (one
        FIFO queue, one sender).

        The sender is also the DURABILITY BARRIER: each outbox item
        carries the WAL seq its reply must wait on, and the sender calls
        ``wal.sync(seq)`` (group-commit fsync) before the reply bytes hit
        the socket — no acknowledged write can be lost to a crash. Running
        the barrier here rather than in dispatch keeps the receive loop
        pipelined: the next request decodes and executes while this
        reply's batch fsyncs, which is exactly what lets one fsync absorb
        a whole burst of concurrent mutations."""
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # AF_UNIX connections have no Nagle to disable
        self._conns.add(conn)
        outbox: "queue.Queue" = queue.Queue(maxsize=256)
        dead = threading.Event()

        def _sender() -> None:
            while True:
                item = outbox.get()
                if item is None:
                    return
                reply, barrier, wire = item
                if dead.is_set():
                    continue  # drain: never block the recv loop on a dead peer
                if barrier:
                    wal = self._wal
                    if wal is not None:
                        wal.sync(barrier)
                    if faults.fire("crash_server"):
                        # chaos: the write IS durable, the reply never
                        # leaves — the client's retry must be answered
                        # from the journaled reply cache after restart
                        os.kill(os.getpid(), _signal_mod.SIGKILL)
                try:
                    if isinstance(reply, (bytes, bytearray)):
                        # preserialized in the REQUEST's wire already
                        # (the enc-cache is wire-keyed): zero re-encoding
                        send_payload(conn, reply)
                    else:
                        send_payload(conn, self._encode_reply(reply, wire))
                except (ConnectionError, BrokenPipeError, OSError,
                        ProtocolError):
                    dead.set()

        sender = threading.Thread(
            target=_sender, name="coord-conn-send", daemon=True)
        sender.start()
        try:
            while not self._stopping.is_set() and not dead.is_set():
                try:
                    payload = recv_payload(conn)
                except (ProtocolError, ConnectionError, OSError):
                    return  # TornFrameError included: drop, client retries
                if payload is None or self._stopping.is_set():
                    return  # drop, don't ack: stop() snapshots after this
                # per-frame codec detection: the reply always goes back in
                # the codec the request arrived in, so one connection may
                # mix v1/v2 freely (rolling upgrades, probe pings)
                wire = "v2" if payload_is_v2(payload) else "v1"
                try:
                    msg = decode_payload(payload)
                except (ProtocolError, json.JSONDecodeError,
                        UnicodeDecodeError):
                    return  # undecodable frame: the stream is unsynced
                reply = self._handle(msg, wire)
                # barrier read AFTER dispatch: covers every record the op
                # appended (possibly more — that only widens the batch)
                outbox.put((reply, self._barrier_seq(msg.get("op")), wire))
        finally:
            outbox.put(None)
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            sender.join(timeout=2)

    #: ops where a blind retry would double-execute; their replies are cached
    #: by request id. Read-only ops re-execute harmlessly and are not cached
    #: by request id (the hot fetch replies are instead cached as encoded
    #: bytes keyed by the mutation counter — see _enc_cache).
    _MUTATING_OPS = frozenset(
        {"create_experiment", "update_experiment", "delete_experiment",
         "register", "reserve", "update_trial", "release_stale",
         "set_signal"}
    )
    #: read replies preserialized once per commit and shared by observers
    _CACHED_READS = frozenset({"fetch", "fetch_completed_since"})

    def _op_lock(self, op: str, a: Dict[str, Any]) -> threading.RLock:
        """The experiment lock a mutating op must hold across its
        cache-check + execute + cache-store (same name derivation as
        :meth:`_ShardedLedger._exp_of`, so the proxy re-enters it)."""
        if op == "create_experiment":
            name = (a.get("config") or {}).get("name")
        elif op in ("register", "update_trial"):
            name = (a.get("trial") or {}).get("experiment")
        else:
            name = a.get("experiment") or a.get("name")
        return self._exp_lock(name)

    def _hosted_producer(self, name: str):
        """The coordinator-owned (Producer, lock, coalescer) for an
        experiment (lazy).

        After a restart this rebuilds from scratch: the Experiment adopts
        the (restored) ledger doc and the algorithm re-learns everything on
        its first ``observe`` over the completed trials — the
        observe-replay resume doctrine.
        """
        if not self.host_algorithms:
            raise ValueError("coordinator does not host algorithms")
        with self._producers_guard:
            entry = self._producers.get(name)
            if entry is None:
                from metaopt_tpu_torch.algo.base import BaseAlgorithm, make_algorithm
                from metaopt_tpu_torch.ledger.experiment import Experiment
                from metaopt_tpu_torch.worker.producer import Producer

                if self.ledger.load_experiment(name) is None:
                    raise KeyError(f"experiment {name!r} not found")
                # _producers_guard -> EXP is the canonical order
                # (delete_experiment pops producers OUTSIDE the ledger
                # locks for this reason); the reverse edge closing the
                # cycle is the phantom mutating-dispatch edge above
                exp = Experiment(name, ledger=self.ledger).configure()  # mtpu: lint-ok MTL001 canonical guard->EXP order; reverse edge is phantom
                algo = make_algorithm(exp.space,
                                      self._placed(exp.algorithm))
                if (self.suggest_prefetch_depth > 1
                        and hasattr(algo, "suggest_prefetch_depth")):
                    algo.suggest_prefetch_depth = self.suggest_prefetch_depth
                producer = Producer(exp, algo)
                # algorithms that never suspend (the base no-op) let the
                # suspend verdict skip the producer lock entirely — asking
                # a trivial question must not queue behind a running fit
                producer.suspend_is_noop = (
                    type(algo).should_suspend is BaseAlgorithm.should_suspend
                )
                # passive = nothing consults the fit BETWEEN produce
                # cycles (no judge, no suspension verdicts), so observe
                # timing is unobservable and workers may skip provably
                # no-op produce legs (see worker_cycle's ``algo_passive``)
                producer.algo_passive = (
                    producer.suspend_is_noop
                    and type(algo).judge is BaseAlgorithm.judge
                )
                entry = (producer, threading.Lock())
                self._producers[name] = entry

                def on_cycle(batch, _name=name, _algo=algo):
                    res = batch.result or {}
                    if res.get("registered"):
                        self._event(
                            "produce", _name,
                            registered=res["registered"],
                            coalesced=res["coalesced"],
                            workers=[w for w in batch.workers if w],
                            # the port's: the observations the fit held
                            # when it suggested (a moved experiment's new
                            # owner must hold every shipped completion)
                            observed=getattr(_algo, "n_observed", None),
                        )
                    # re-arm the speculative pool the cycle just drained —
                    # only spawns a daemon thread, so the waiters blocked
                    # on batch.done see no added latency
                    kick = getattr(_algo, "_suggest_ahead_async", None)
                    if kick is not None:
                        kick()

                self._coalescers[name] = _ProduceCoalescer(
                    entry[0], entry[1],
                    self.produce_coalesce_ms / 1000.0, on_cycle,
                    clock=self.clock,
                )
            coalescer = self._coalescers[name]
        return entry[0], entry[1], coalescer

    def _placed(self, algo_cfg: Dict[str, Any]) -> Dict[str, Any]:
        """``algo_cfg`` with this server's device added for an algorithm
        whose constructor takes one and whose config names none. The copy
        goes to the constructor only: the experiment document keeps the
        configuration as stored."""
        from metaopt_tpu_torch.algo.base import accepts_device

        if len(algo_cfg) != 1:
            return algo_cfg
        (name, kwargs), = algo_cfg.items()
        kwargs = dict(kwargs or {})
        if "device" not in kwargs and accepts_device(name):
            kwargs["device"] = self.device
        return {name: kwargs}

    def _worker_cycle(self, a: Dict[str, Any]) -> Dict[str, Any]:
        """One fused worker trial cycle: push → sweep → produce → reserve
        → counts.

        Collapses the ~5 RPCs a coord-mode workon cycle used to cost
        (update_trial, release_stale, produce, reserve, count, is_done's
        doc+count reads) into one round-trip. Semantics mirror the serial
        sequence exactly:

        - the previous trial's result push rides in first (``complete``:
          the worker defers its terminal ``update_trial`` to the next
          cycle, halving the steady-state round-trips to ~1 per trial);
          exactly-once comes from the worker_cycle reply cache, which
          already guards the embedded reserve,
        - the stale sweep runs next (only when the caller's throttle asks
          for it, via ``stale_timeout_s``),
        - ``Experiment.is_done`` is evaluated server-side BEFORE the
          produce/reserve legs, mirroring the serial loop's
          ``is_done → produce → reserve`` order: a cycle whose own
          completion leg just finished the experiment returns
          ``trial=None`` instead of reserving work the serial loop would
          never have reserved,
        - the produce leg funnels through the SAME per-experiment
          coalescer as the ``produce`` op, so fused and serial clients
          group-commit together and the registered suggestion stream is
          bit-identical to serial serving,
        - the reserved trial (if any) ships with its pending control
          signal and the hosted algorithm's ``should_suspend`` verdict, so
          the worker needs no follow-up RPC before executing,
        - ``counts`` + the experiment doc's budget/algo_done let the worker
          evaluate ``Experiment.is_done`` locally next cycle.
        """
        name = a["experiment"]
        worker = a.get("worker") or "worker"
        out: Dict[str, Any] = {
            "released": 0, "registered": 0, "algo_done": False,
            "coalesced": 0, "trial": None, "signal": None, "suspend": False,
            "completed_ok": None,
        }
        entry = self._producers.get(name)
        if entry is not None:
            # tells the worker it may skip provably no-op produce legs:
            # nothing consults this algorithm's fit between produce cycles
            out["algo_passive"] = getattr(entry[0], "algo_passive", False)
        complete = a.get("complete")
        if complete:
            # single-trial ("trial") and multi-trial ("trials", the batched
            # hunt's whole-pool push) forms; oks are positional either way
            docs = complete.get("trials")
            single = docs is None
            if single:
                docs = [complete["trial"]]
            oks = []
            for doc_t in docs:
                t = Trial.from_dict(doc_t)
                ok = bool(self.ledger.update_trial(
                    t,
                    expected_status=complete.get("expected_status", "reserved"),
                    expected_worker=complete.get("expected_worker"),
                ))
                oks.append(ok)
                if ok:
                    self._event("update_trial", name, trial=t.id,
                                status=t.status)
            out["completed_oks"] = oks
            if single:
                out["completed_ok"] = oks[0]
        timeout_s = a.get("stale_timeout_s")
        if timeout_s is not None:
            released = self.ledger.release_stale(name, float(timeout_s))
            out["released"] = len(released)
            for t in released:
                self._event("release_stale", name, trial=t.id)
        doc = self.ledger.load_experiment(name)
        if doc is None:
            raise KeyError(f"experiment {name!r} not found")
        out["max_trials"] = doc.get("max_trials")
        out["exp_algo_done"] = bool(doc.get("algo_done"))
        max_trials = doc.get("max_trials")
        done = (max_trials is not None
                and self.ledger.count(name, "completed") >= max_trials)
        if not done and out["exp_algo_done"]:
            done = self.ledger.count(name, ("new", "reserved")) == 0
        if not done:
            producer = plock = None
            do_produce = a.get("produce", True)
            if do_produce and not self._produce_admit(name):
                # fair scheduling (coord/tenancy.py): this tenant is past
                # its deficit-round-robin share of produce capacity, so
                # the produce leg is skipped THIS cycle — the rest of the
                # cycle (complete/sweep/reserve/counts) ran untouched and
                # the worker retries the leg next cycle
                do_produce = False
                out["throttled"] = True
            if do_produce:
                producer, plock, coalescer = self._hosted_producer(name)
                pres = coalescer.produce(a.get("pool_size"), worker=worker)
                out["registered"] = pres["registered"]
                out["algo_done"] = pres["algo_done"]
                out["coalesced"] = pres["coalesced"]
                # produce may have just exhausted the algorithm; the doc
                # write (mark_algo_done) happened inside the cycle, so
                # surface it without a second doc load
                out["exp_algo_done"] = out["exp_algo_done"] or pres["algo_done"]
                out["algo_passive"] = getattr(producer, "algo_passive", False)
            t = self.ledger.reserve(name, worker)
            if t is not None:
                self._event("reserve", name, trial=t.id, worker=worker)
                out["trial"] = t.to_dict()
                with self._sig_lock:
                    out["signal"] = self._signals.get((name, t.id))
                if producer is None and self.host_algorithms:
                    # produce was skipped this cycle, but the suspension
                    # verdict is still owed for every reservation
                    producer, plock, _ = self._hosted_producer(name)
                if producer is not None and not getattr(
                        producer, "suspend_is_noop", False):
                    with plock:
                        out["suspend"] = bool(
                            producer.algorithm.should_suspend(t))
        out["counts"] = {
            s: self.ledger.count(name, s)
            for s in ("new", "reserved", "completed")
        }
        return out

    def _handle_worker_cycle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """worker_cycle dispatch with exactly-once retry semantics.

        The cycle embeds a reserve, so a retry whose original reply was
        lost must be answered from the reply cache — and a retry racing
        the still-running original must WAIT for that reply rather than
        re-execute (the in-flight event mirrors what holding the dispatch
        lock achieves for single-op mutations)."""
        req = msg.get("req")
        if req:
            with self._replies_lock:
                cached = self._replies.get(req)
            if cached is not None:
                return cached
            with self._inflight_lock:
                ev = self._inflight.get(req)
                owner = ev is None
                if owner:
                    ev = self._inflight[req] = threading.Event()
            if not owner:
                ev.wait(timeout=600.0)
                with self._replies_lock:
                    cached = self._replies.get(req)
                if cached is not None:
                    return cached
                return {"ok": False, "error": "CoordRPCError",
                        "msg": "worker_cycle retry raced an unfinished "
                               "original past the wait budget"}
        try:
            self._ops = next(self._op_counter)
            self._tl.reply_journaled = req is not None
            result = self._worker_cycle(msg.get("args") or {})
            reply: Dict[str, Any] = {"ok": True, "result": result}
        except Exception as e:
            reply = {"ok": False, "error": type(e).__name__, "msg": str(e)}
        finally:
            self._tl.reply_journaled = False
        if req:
            exp = (msg.get("args") or {}).get("experiment")
            self._cache_reply(req, reply, exp=exp)
            # journaled BEFORE the in-flight event releases any waiting
            # retry: the sender-thread barrier fsyncs it with the cycle's
            # own records, so a retry straddling a crash still hits cache
            self._journal_reply(req, reply, exp=exp)
            with self._inflight_lock:
                ev = self._inflight.pop(req, None)
            if ev is not None:
                ev.set()
        return reply

    @staticmethod
    def _encode_reply(reply: Dict[str, Any], wire: str) -> bytes:
        """Reply payload bytes in ``wire``; a reply the binary codec cannot
        carry falls back to JSON for that frame (receivers auto-detect)."""
        if wire == "v2":
            try:
                return encode_reply_v2(reply)
            except ProtocolError:
                pass
        return encode_msg(reply)

    #: the hand-off admin plane (coord/handoff.py drives it): never
    #: fenced, never reply-cached — every op is idempotent by design so
    #: the orchestrator may blindly retry through a chaos kill
    _HANDOFF_OPS = frozenset(
        {"handoff_prepare", "handoff_apply", "handoff_abort",
         "shard_map_update"}
    )

    def _handle_handoff(self, op: str,
                        a: Dict[str, Any]) -> Dict[str, Any]:
        """Route one admin-plane op; marshals errors like _handle_body."""
        try:
            if op == "handoff_prepare":
                return self._handoff_prepare(a)
            if op == "handoff_apply":
                return self._handoff_apply(a)
            if op == "handoff_abort":
                exp = a["experiment"]
                with self._map_cv:
                    self._migrating.pop(exp, None)
                    if self._wal is not None:
                        # un-arm the journaled fence too, or a restart
                        # would replay it back into place
                        self._wal.append({"op": "handoff_abort",
                                          "experiment": exp})
                    self._map_cv.notify_all()
                return {"ok": True, "result": True}
            return self._shard_map_update(a)
        except Exception as e:
            return {"ok": False, "error": type(e).__name__, "msg": str(e)}

    def _handoff_prepare(self, a: Dict[str, Any]) -> Dict[str, Any]:
        """SOURCE side of a live migration: fence, drain, capture.

        Fences ``experiment`` (new ops get a retryable ``Migrating``),
        waits until its in-flight dispatches drain, then captures a
        crash-atomic per-experiment snapshot — the experiment doc, every
        trial doc, pending control signals, the reply-cache entries that
        make in-flight exactly-once retries survive the move, and the
        experiment's WAL tail (extracted under a compaction fence). The
        fence STAYS armed after the reply: it is lifted by the ownership
        commit (``shard_map_update`` with ``drop``) or by
        ``handoff_abort``. A crash before commit loses only the
        in-memory fence — the source recovers still owning the
        experiment and the orchestrator starts over.
        """
        exp = a["experiment"]
        dest = a["dest"]
        drain_s = float(a.get("drain_timeout_s", 10.0))
        if self._ring is None:
            raise ValueError("not a sharded server")
        with self._map_cv:
            if self._ring.owner(exp) != self.shard_id:
                return {
                    "ok": False, "error": "WrongShardError",
                    "msg": f"experiment {exp!r} is not owned by "
                           f"{self.shard_id}",
                }
            cur = self._migrating.get(exp)
            if cur is not None and cur != dest:
                return {"ok": False, "error": "CoordRPCError",
                        "msg": f"experiment {exp!r} already migrating "
                               f"to {cur}"}
            self._migrating[exp] = dest
            if self._wal is not None:
                # the fence must survive a source crash BETWEEN capture
                # and commit: without this record a respawned source
                # would accept writes the commit then deletes. Durable
                # before any state ships — extract_tail below flushes
                # the buffer, and the reply itself waits on the
                # _DURABLE_OPS sender barrier.
                self._wal.append({"op": "handoff_fence",
                                  "experiment": exp, "dest": dest})
            deadline = self.clock.monotonic() + drain_s
            while self._exp_inflight.get(exp, 0) > 0:
                remaining = deadline - self.clock.monotonic()
                if remaining <= 0:
                    self._migrating.pop(exp, None)
                    if self._wal is not None:
                        self._wal.append({"op": "handoff_abort",
                                          "experiment": exp})
                    self._map_cv.notify_all()
                    return {"ok": False, "error": "CoordRPCError",
                            "msg": f"drain of {exp!r} timed out with "
                                   f"{self._exp_inflight.get(exp, 0)} "
                                   "ops in flight"}
                self._map_cv.wait(timeout=min(0.05, remaining))
        if faults.fire("crash_handoff_source"):
            # barrier 1 (pre-snapshot): fenced + drained, nothing captured
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        if self._evict_enabled:
            # an evicted experiment ships resident: page it back in under
            # the fence so the capture below sees the full state
            self.hydrate_experiment(exp)
        wal = self._wal
        try:
            with self._exp_lock(exp):
                doc = self.inner.load_experiment(exp)
                if doc is None:
                    raise KeyError(f"experiment {exp!r} not found")
                trials = [t.to_dict() for t in self.inner.fetch(exp)]
            with self._sig_lock:
                signals = [{"trial_id": t, "signal": s}
                           for (e, t), s in self._signals.items()
                           if e == exp]
            with self._replies_lock:
                replies = [{"req": r, "reply": self._replies[r]}
                           for r, e in self._reply_exps.items()
                           if e == exp and r in self._replies]
            tail: list = []
            if wal is not None:
                # the fence holds compaction off while the tail is read —
                # a snapshot's compact() racing this extraction could
                # rewrite the log under it (satellite: fenced compaction)
                with wal.compaction_fence():
                    tail = wal.extract_tail(exp)
        except Exception:
            with self._map_cv:
                self._migrating.pop(exp, None)
                if self._wal is not None:
                    self._wal.append({"op": "handoff_abort",
                                      "experiment": exp})
                self._map_cv.notify_all()
            raise
        if faults.fire("crash_handoff_source"):
            # barrier 2 (post-snapshot): captured, nothing shipped
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        return {"ok": True, "result": {
            "experiment": doc, "trials": trials, "signals": signals,
            "replies": replies, "wal_tail": tail,
        }}

    def _handoff_apply(self, a: Dict[str, Any]) -> Dict[str, Any]:
        """DESTINATION side: journal + adopt one shipped experiment.

        Idempotent by construction — every piece is an upsert and the
        map adoption is version-gated — so the orchestrator retries it
        verbatim through a chaos kill. The shipped reply-cache entries
        (list + any journaled reply records in the WAL tail) are
        installed AND re-journaled here, so an exactly-once
        ``worker_cycle`` retry that lands after the move (even after a
        further dest crash) is answered from cache, not re-executed.
        """
        exp = a["experiment"]
        state = a["state"]
        new_map = a.get("shard_map")
        if faults.fire("crash_handoff_dest"):
            # barrier 3 (dest pre-commit): nothing applied yet
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        wal = self._wal
        applied_trials = 0
        with self._exp_lock(exp):
            if self.inner.load_experiment(exp) is None:
                cfg = state["experiment"]
                self.inner.create_experiment(cfg)
                if wal is not None:
                    wal.append({"op": "create_experiment", "config": cfg})
            for doc in state.get("trials") or []:
                if faults.fire("torn_handoff_ship"):
                    # die mid-ship: a prefix of the docs is journaled
                    # durable, the rest never landed — the retried apply
                    # must complete the move idempotently (fsync under
                    # EXP is fine: SIGKILL on the next line, nothing
                    # else ever runs in this incarnation)
                    if wal is not None:
                        wal.sync(wal.appended_seq)  # mtpu: lint-ok MTL002 chaos-only; process SIGKILLs itself next line
                    os.kill(os.getpid(), _signal_mod.SIGKILL)
                self.inner.put_trial(Trial.from_dict(doc))
                if wal is not None:
                    wal.append({"op": "put_trial", "trial": doc})
                applied_trials += 1
            self._mutated(exp)
        with self._sig_lock:
            for sig in state.get("signals") or []:
                self._signals[(exp, sig["trial_id"])] = sig["signal"]
        if wal is not None:
            for sig in state.get("signals") or []:
                wal.append({"op": "set_signal", "experiment": exp,
                            "trial_id": sig["trial_id"],
                            "signal": sig["signal"]})
        shipped = {r["req"]: r["reply"]
                   for r in state.get("replies") or []}
        for rec in state.get("wal_tail") or []:
            # the tail's mutation records are subsumed by the shipped doc
            # state; only its reply records (entries evicted from the
            # in-memory cache but still journaled) add coverage
            if rec.get("op") == "reply" and rec.get("req") not in shipped:
                shipped[rec["req"]] = rec["reply"]
        for req, reply in shipped.items():
            self._cache_reply(req, reply, exp=exp)
            self._journal_reply(req, reply, exp=exp)
        if new_map is not None:
            with self._map_cv:
                if map_version(new_map) > map_version(self.shard_map):
                    self.shard_map = new_map
                    if self.shard_id is not None:
                        self._ring = RoutingTable(new_map)
                    if wal is not None:
                        wal.append({"op": "shard_map", "map": new_map})
                self._migrating.pop(exp, None)
                self._map_cv.notify_all()
        if wal is not None:
            # make the adoption durable HERE, not just at the sender
            # barrier: the post-commit chaos kill below must only ever
            # fire with everything above already on disk
            wal.sync(wal.appended_seq)
        if faults.fire("crash_handoff_dest"):
            # barrier 4 (dest post-commit): durable, reply never leaves —
            # the orchestrator's retry is answered idempotently
            os.kill(os.getpid(), _signal_mod.SIGKILL)
        return {"ok": True, "result": {
            "trials": applied_trials, "replies": len(shipped),
            "map_version": map_version(self.shard_map),
        }}

    def _shard_map_update(self, a: Dict[str, Any]) -> Dict[str, Any]:
        """Adopt a bumped shard map (version-gated, monotonic) and drop
        local copies of experiments whose ownership moved away.

        This is the OWNERSHIP COMMIT on the migration source: adopting
        the new map makes it answer ``WrongShardError`` for the moved
        experiment (clients re-learn and follow), the journaled
        ``shard_map`` record + post-delete WAL records make the commit
        crash-durable, and the fence is lifted last.
        """
        new_map = a["shard_map"]
        drop = list(a.get("drop") or [])
        adopted = False
        with self._map_cv:
            if map_version(new_map) > map_version(self.shard_map):
                self.shard_map = new_map
                if self.shard_id is not None:
                    self._ring = RoutingTable(new_map)
                if self._wal is not None:
                    self._wal.append({"op": "shard_map", "map": new_map})
                adopted = True
            for exp in drop:
                self._migrating.pop(exp, None)
            self._map_cv.notify_all()
        for exp in drop:
            # the moved experiment's local copy dies with the commit —
            # the ledger proxy journals the delete under the exp lock
            self.ledger.delete_experiment(exp)
            with self._sig_lock:
                self._signals = {k: v for k, v in self._signals.items()
                                 if k[0] != exp}
            with self._producers_guard:
                self._producers.pop(exp, None)
                self._coalescers.pop(exp, None)
            with self._replies_lock:
                for req in [r for r, e in self._reply_exps.items()
                            if e == exp]:
                    self._reply_exps.pop(req, None)
                    self._replies.pop(req, None)
        return {"ok": True, "result": {
            "adopted": adopted,
            "map_version": map_version(self.shard_map),
        }}

    @staticmethod
    def _encode_reply(reply: Dict[str, Any], wire: str) -> bytes:
        """Reply payload bytes in ``wire``; a reply the binary codec cannot
        carry falls back to JSON for that frame (receivers auto-detect)."""
        if wire == "v2":
            try:
                return encode_reply_v2(reply)
            except ProtocolError:
                pass
        return encode_msg(reply)

    def _handle(self, msg: Dict[str, Any],
                wire: str = "v1") -> Union[Dict[str, Any], bytes]:
        """Dispatch one request; returns a reply dict or preencoded bytes.

        Mutating ops hold their EXPERIMENT's lock across reply-cache
        lookup + dispatch + store — a retry arriving while the original
        request is still executing blocks on that lock and then hits the
        cache, so "reply lost mid-dispatch" cannot double-execute reserve.
        (Scope: connection drops. A coordinator *restart* clears the cache;
        orphaned reservations from that path are reclaimed by the stale
        sweep.) Read ops take no server lock at all.

        On a sharded server every experiment-named op first clears the
        migration fence + ownership check under ``_map_cv`` and is
        counted in ``_exp_inflight`` for its whole dispatch, so a
        hand-off can quiesce one experiment (fence new ops with a
        retryable ``Migrating``, wait for the in-flight count to drain)
        without stalling any other experiment's traffic.
        """
        op = msg.get("op")
        if op in self._HANDOFF_OPS:
            return self._handle_handoff(op, msg.get("args") or {})
        exp = None
        if (self._ring is not None or self._evict_enabled) and op not in (
                "ping", "snapshot", "list_experiments", "tenant_stats"):
            # sharded serving: refuse experiment-named ops this shard does
            # not own BEFORE any cache or dispatch — accepting one would
            # split the experiment's state across two shards' ledgers.
            # Never cached (a stale-map retry must re-check after the
            # client refreshes its routing table). An eviction-enabled
            # server runs the same fence + in-flight accounting even
            # unsharded: evict_experiment drains through it exactly like
            # a hand-off, so a capture can never interleave a dispatch.
            exp = experiment_of(op, msg.get("args") or {})
            if exp is not None:
                with self._map_cv:
                    # ownership BEFORE the fence: after the commit a
                    # recovered (journaled) fence may still be armed for
                    # an experiment this shard no longer owns, and the
                    # client must be told to re-learn the map, not to
                    # retry here forever
                    if self._ring is not None:
                        owner = self._ring.owner(exp)
                        if owner != self.shard_id:
                            return {
                                "ok": False, "error": "WrongShardError",
                                "msg": f"experiment {exp!r} is owned by "
                                       f"shard {owner}, not {self.shard_id}",
                            }
                    dest = self._migrating.get(exp)
                    if dest is not None:
                        return {
                            "ok": False, "error": "Migrating",
                            "msg": f"experiment {exp!r} is migrating to "
                                   f"shard {dest}; retry shortly",
                        }
                    # counted under the SAME cv hold as the fence check:
                    # an op admitted here is visible to a later prepare's
                    # drain wait, an op arriving after the fence is not
                    self._exp_inflight[exp] = (
                        self._exp_inflight.get(exp, 0) + 1)
        if exp is None:
            return self._handle_body(op, msg, wire)
        try:
            if self._evict_enabled:
                with self._evict_lock:
                    self._exp_last_touch[exp] = self.clock.monotonic()
                    stubbed = exp in self._evicted
                if stubbed and op not in self._NO_HYDRATE_OPS:
                    try:
                        self.hydrate_experiment(exp)
                    except Exception as e:
                        return {"ok": False, "error": type(e).__name__,
                                "msg": str(e)}
            return self._handle_body(op, msg, wire)
        finally:
            with self._map_cv:
                n = self._exp_inflight.get(exp, 0) - 1
                if n <= 0:
                    self._exp_inflight.pop(exp, None)
                else:
                    self._exp_inflight[exp] = n
                if self._migrating:
                    self._map_cv.notify_all()

    def _handle_body(self, op: Optional[str], msg: Dict[str, Any],
                     wire: str = "v1") -> Union[Dict[str, Any], bytes]:
        if op in ("produce", "judge", "should_suspend"):
            # dispatched outside every ledger lock: an algorithm fit (TPE
            # at 10k observations takes seconds) must not stall heartbeats
            # — a blocked heartbeat path lets the stale sweep reclaim LIVE
            # reservations. The per-experiment producer lock serializes
            # the shared algorithm; its ledger ops re-enter the
            # experiment's ledger lock one at a time via _ShardedLedger.
            # Not reply-cached: a retried produce just registers extra
            # suggestions, absorbed by the budget check + ledger dedup
            # exactly like decentralized producer races.
            try:
                a = msg.get("args") or {}
                producer, plock, coalescer = self._hosted_producer(
                    a["experiment"])
                if op == "produce":
                    if not self._produce_admit(a["experiment"]):
                        # fair-scheduling skip, same contract as the
                        # worker_cycle leg: registered=0 is the workon
                        # loop's ordinary idle signal, retried next cycle
                        return {"ok": True, "result": {
                            "registered": 0, "algo_done": False,
                            "coalesced": 1, "throttled": True}}
                    # concurrent produce RPCs group-commit: one combined
                    # cycle per coalescing window (event emitted there)
                    result: Any = coalescer.produce(
                        a.get("pool_size"), worker=a.get("worker"))
                elif op == "judge":
                    with plock:
                        result = producer.algorithm.judge(
                            Trial.from_dict(a["trial"]), a["partial"]
                        )
                elif getattr(producer, "suspend_is_noop", False):
                    # base no-op verdict: answer without queueing behind a
                    # running fit on the producer lock
                    result = False
                else:
                    with plock:
                        result = bool(producer.algorithm.should_suspend(
                            Trial.from_dict(a["trial"])
                        ))
                return {"ok": True, "result": result}
            except Exception as e:
                return {"ok": False, "error": type(e).__name__, "msg": str(e)}
        if op == "worker_cycle":
            return self._handle_worker_cycle(msg)
        if op == "snapshot":
            # dispatched outside the ledger locks: snapshot() takes
            # _snap_lock then each experiment's lock in turn, and holding
            # one here first would AB-BA against the housekeeping/stop()
            # snapshot path
            try:
                a = msg.get("args") or {}
                path = a.get("path") or self.snapshot_path
                if not path:
                    raise ValueError("no snapshot path configured")
                self.snapshot(path)
                return {"ok": True, "result": path}
            except Exception as e:
                return {"ok": False, "error": type(e).__name__, "msg": str(e)}
        a = msg.get("args") or {}
        if op in self._CACHED_READS:
            # preserialized-reply fast path: the counter is read BEFORE the
            # fetch executes, so an entry can only ever be stamped older
            # than the data it holds — a racing commit makes the entry
            # miss, never serves stale bytes
            exp = a.get("experiment")
            mut = self._mut.get(exp, 0)
            # wire-keyed: a JSON observer and a binary observer at the
            # same cursor each get bytes preserialized ONCE in their own
            # codec, and the sender writes them with zero re-encoding
            key = (op, exp, wire, json.dumps(a, sort_keys=True, default=str))
            with self._enc_lock:
                ent = self._enc_cache.get(key)
                if ent is not None and ent[0] == mut:
                    self._enc_cache.move_to_end(key)
                    self._enc_hits += 1
                    return ent[1]
            try:
                payload = self._encode_reply(
                    {"ok": True, "result": self._dispatch(op, a)}, wire)
            except Exception as e:  # errors are not worth caching
                return {"ok": False, "error": type(e).__name__, "msg": str(e)}
            with self._enc_lock:
                self._enc_cache[key] = (mut, payload)
                self._enc_cache.move_to_end(key)
                while len(self._enc_cache) > self._enc_cap:
                    self._enc_cache.popitem(last=False)
            return payload
        if op in self._MUTATING_OPS:
            req = msg.get("req")
            with self._op_lock(op, a):
                if req is not None:
                    with self._replies_lock:
                        cached = self._replies.get(req)
                    if cached is not None:
                        return cached
                try:
                    self._tl.reply_journaled = req is not None
                    # the EXP -> _producers_guard edge the call graph sees
                    # here is phantom: this branch only dispatches
                    # _MUTATING_OPS, and the guard-taking read ops
                    # (tenant_stats) are dispatched lock-free below
                    reply = {"ok": True, "result": self._dispatch(op, a)}  # mtpu: lint-ok MTL001 mutating-ops-only dispatch never reaches tenant_stats
                except Exception as e:  # marshal, don't crash the service
                    reply = {"ok": False, "error": type(e).__name__,
                             "msg": str(e)}
                finally:
                    self._tl.reply_journaled = False
                if req is not None:
                    exp_key = experiment_of(op, a)
                    self._cache_reply(req, reply, exp=exp_key)
                    self._journal_reply(req, reply, exp=exp_key)
            if (op == "delete_experiment" and reply.get("ok")
                    and reply.get("result")):
                # the hosted algorithm dies with the experiment — popped
                # here, outside the ledger locks, because _hosted_producer
                # nests the two guards in the opposite order
                # (_producers_guard → experiment lock)
                with self._producers_guard:
                    self._producers.pop(a.get("name"), None)
                    self._coalescers.pop(a.get("name"), None)
                # durability: restore() merges a stale snapshot's docs back
                # in, which would RESURRECT the deleted experiment after a
                # crash. With a WAL the delete record in the tail already
                # replays over any stale snapshot, so the serving thread
                # only REQUESTS a snapshot and the housekeeping loop pays
                # for it — the request path stays flat. Without a WAL the
                # snapshot is the only durability there is: take it inline.
                # Outside the ledger locks either way: snapshot takes
                # _snap_lock → exp locks (AB-BA with housekeeping
                # otherwise).
                if self.snapshot_path:
                    if self._wal is not None:
                        self._snap_soon.set()
                    else:
                        try:
                            self.snapshot(self.snapshot_path)
                        except Exception:
                            log.exception("post-delete snapshot failed")
            return reply
        # plain reads (get/count/load/list/heartbeat/ping): no server lock,
        # no caches — the backend's own locking is the only serialization
        try:
            return {"ok": True, "result": self._dispatch(op, a)}
        except Exception as e:
            return {"ok": False, "error": type(e).__name__, "msg": str(e)}

    def _dispatch(self, op: Optional[str], a: Dict[str, Any]) -> Any:
        self._ops = next(self._op_counter)
        if op == "ping":
            reply = {"pong": True, "ops": self._ops, "caps": list(CAPS),
                     "incarnation": self._incarnation,
                     "durable": self._wal is not None}
            if self.uds_path and self._uds_sock is not None:
                # same-host fast path: clients that can reach this socket
                # path locally switch their connections to it (old clients
                # ignore the field — wire framing is unchanged)
                reply["uds_path"] = self.uds_path
            if self._ring is not None:
                # sharded serving: teach the client the map so its next
                # call routes straight to the owning shard; read under
                # _map_cv so a concurrent hand-off commit can never hand
                # out a half-swapped map
                reply["caps"] = reply["caps"] + ["shard_map"]
                with self._map_cv:
                    reply["shard_map"] = self.shard_map
                reply["shard_id"] = self.shard_id
                # the port's device rule: each shard process owns its own
                # device context, and says which (and who it is) here
                reply["pid"] = os.getpid()
                reply["device"] = (None if self.device is None
                                   else str(self.device))
            return reply
        if op == "create_experiment":
            cfg = a["config"]
            name = cfg.get("name")
            tenant = str(cfg.get("tenant") or "default")
            with self._evict_lock:
                if name in self._evicted:
                    # the name exists — its state just lives in an evict
                    # file; admitting a second life would fork identity
                    raise DuplicateExperimentError(name)
            if (self.max_experiments is not None
                    or self.max_experiments_per_tenant is not None):
                # admission-control gate: reject past configured limits
                # BEFORE the ledger write; callers see AdmissionError and
                # must shed load, it is not a retryable race
                with self._tenant_lock:
                    known = name in self._tenant_of
                    total = len(self._tenant_of)
                    mine = sum(1 for t in self._tenant_of.values()
                               if t == tenant)
                if not known:
                    if (self.max_experiments is not None
                            and total >= self.max_experiments):
                        raise AdmissionError(
                            f"server at capacity ({total} experiments, "
                            f"limit {self.max_experiments})")
                    if (self.max_experiments_per_tenant is not None
                            and mine >= self.max_experiments_per_tenant):
                        raise AdmissionError(
                            f"tenant {tenant!r} at quota ({mine} "
                            "experiments, limit "
                            f"{self.max_experiments_per_tenant})")
            self.ledger.create_experiment(cfg)
            with self._tenant_lock:
                self._tenant_of[name] = tenant
            if self._evict_enabled:
                with self._evict_lock:
                    self._exp_last_touch[name] = self.clock.monotonic()
            self._event("create_experiment", name)
            return None
        if op == "tenant_stats":
            return self._tenant_stats(a)
        if op == "load_experiment":
            if self._evict_enabled:
                with self._evict_lock:
                    stub = self._evicted.get(a["name"])
                if stub is not None and stub.get("experiment") is not None:
                    return stub["experiment"]
            return self.ledger.load_experiment(a["name"])
        if op == "update_experiment":
            self.ledger.update_experiment(a["name"], a["patch"])
            return None
        if op == "list_experiments":
            names = self.ledger.list_experiments()
            if self._evict_enabled:
                with self._evict_lock:
                    extra = [n for n in self._evicted if n not in set(names)]
                if extra:
                    names = list(names) + sorted(extra)
            return names
        if op == "delete_experiment":
            name = a["name"]
            ok = bool(self.ledger.delete_experiment(name))
            with self._tenant_lock:
                self._tenant_of.pop(name, None)
            with self._evict_lock:
                self._evicted.pop(name, None)
                self._exp_last_touch.pop(name, None)
            if ok:
                # pending signals die with the docs. The hosted producer
                # is popped later, OUTSIDE the ledger locks (the
                # post-reply hook in _handle): taking _producers_guard
                # here would AB-BA against _hosted_producer, which holds
                # _producers_guard while its ledger ops take exp locks
                with self._sig_lock:
                    self._signals = {
                        k: v for k, v in self._signals.items()
                        if k[0] != name
                    }
                self._event("delete_experiment", name)
            return ok
        if op == "register":
            trial = Trial.from_dict(a["trial"])
            self.ledger.register(trial)
            self._event("register", trial.experiment, trial=trial.id)
            return None
        if op == "reserve":
            t = self.ledger.reserve(a["experiment"], a["worker"])
            if t is not None:
                self._event(
                    "reserve", a["experiment"], trial=t.id, worker=a["worker"]
                )
            return t.to_dict() if t else None
        if op == "update_trial":
            trial = Trial.from_dict(a["trial"])
            ok = self.ledger.update_trial(
                trial,
                expected_status=a.get("expected_status"),
                expected_worker=a.get("expected_worker"),
            )
            if ok:
                self._event(
                    "update_trial", trial.experiment,
                    trial=trial.id, status=trial.status,
                )
                if trial.status in ("completed", "broken", "interrupted"):
                    with self._sig_lock:
                        self._signals.pop(
                            (trial.experiment, trial.id), None)
            return ok
        if op == "heartbeat":
            ours = self.ledger.heartbeat(
                a["experiment"], a["trial_id"], a["worker"]
            )
            with self._sig_lock:
                signal = self._signals.get((a["experiment"], a["trial_id"]))
            return {"ours": ours, "signal": signal}
        if op == "get":
            t = self.ledger.get(a["experiment"], a["trial_id"])
            return t.to_dict() if t else None
        if op == "fetch":
            status = a.get("status")
            if isinstance(status, list):
                status = tuple(status)
            return [t.to_dict()
                    for t in self.ledger.fetch(a["experiment"], status)]
        if op == "count":
            status = a.get("status")
            if isinstance(status, list):
                status = tuple(status)
            if self._evict_enabled:
                with self._evict_lock:
                    stub = self._evicted.get(a["experiment"])
                if stub is not None:
                    # answered from the stub's O(1) status-count index —
                    # frozen at evict time and exact, because every
                    # mutating op hydrates first (satellite: fleet-wide
                    # status sweeps must not page the fleet back in)
                    counts = stub.get("counts") or {}
                    if status is None:
                        return sum(counts.values())
                    if isinstance(status, tuple):
                        return sum(counts.get(s, 0) for s in status)
                    return counts.get(status, 0)
            return self.ledger.count(a["experiment"], status)
        if op == "fetch_completed_since":
            trials, cur = self.ledger.fetch_completed_since(
                a["experiment"], a.get("cursor")
            )
            return {"trials": [t.to_dict() for t in trials],
                    "cursor": cur}
        if op == "release_stale":
            released = self.ledger.release_stale(a["experiment"],
                                                 a["timeout_s"])
            return [t.to_dict() for t in released]
        if op == "set_signal":
            with self._sig_lock:
                self._signals[(a["experiment"], a["trial_id"])] = a["signal"]
            if self._wal is not None:
                # control signals live outside the ledger, so the sharded
                # proxy never sees them — journal here
                self._wal.append({
                    "op": "set_signal", "experiment": a["experiment"],
                    "trial_id": a["trial_id"], "signal": a["signal"],
                })
            self._event(
                "set_signal", a["experiment"],
                trial=a["trial_id"], signal=a["signal"],
            )
            return None
        raise ValueError(f"unknown op: {op!r}")  # (snapshot: see _handle)


def serve_forever(server: CoordServer) -> None:
    """Run until SIGINT/SIGTERM; used by the ``serve`` CLI command.

    SIGTERM is how pod schedulers preempt — it must snapshot before dying,
    same as Ctrl-C, or everything since the last periodic snapshot is lost.
    """
    import signal as _signal

    stop = threading.Event()
    prev = _signal.signal(_signal.SIGTERM, lambda *_: stop.set())
    server.start()
    host, port = server.address
    print(f"coordinator ready at coord://{host}:{port}", flush=True)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        _signal.signal(_signal.SIGTERM, prev)
