"""Declared invariants the checkers enforce — the port's "lockdep map"
(port of ``metaopt_tpu/analysis/registry.py``, naming the port's classes).

Everything here is *declaration*, not detection: which attribute is
guarded by which lock, which locks must never be held across blocking
calls, which dotted names count as blocking / host-sync, and how the
durability registry in ``coord/protocol.py`` maps onto the server's op
sets. Tests build small configs of the same shape for their fixture
modules, so the checkers stay config-driven and hermetic.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from metaopt_tpu_torch.analysis.core import LintModule

#: pseudo-lock for the server's per-experiment RLock family — every
#: ``_exp_lock(name)`` / ``_op_lock(op, a)`` result is one node, since
#: ordering hazards are against the family, not one instance
EXP_LOCK = "EXP"


@dataclass
class LintConfig:
    """Knobs + declarations for one lint run."""

    # -- lock discipline ---------------------------------------------------
    #: {ClassName: {attr_name}} — attributes that ARE locks; ``with
    #: self.<attr>:`` acquires node "ClassName.<attr>". Classes not listed
    #: fall back to a name heuristic (suffix lock/guard/cv/mutex).
    lock_attrs: Dict[str, Set[str]] = field(default_factory=dict)
    #: {method_name: (returned_lock_node, [locks taken inside the call])}
    #: for lock *factories*: ``with self._exp_lock(n):`` acquires EXP and
    #: briefly takes _exp_locks_guard internally.
    lock_factories: Dict[str, Tuple[str, List[str]]] = field(
        default_factory=dict)
    #: lock nodes that must never be held across a blocking call
    no_block_locks: Set[str] = field(default_factory=set)
    #: dotted-name suffixes that count as blocking (matched against the
    #: call's dotted name tail)
    blocking_calls: Set[str] = field(default_factory=lambda: {
        "os.fsync", "fsync_dir", "time.sleep", "sleep",
        "sendall", "recv", "recv_into", "accept", "connect",
        "recv_msg", "send_msg", "send_payload",
        "subprocess.run", "subprocess.check_call",
        "subprocess.check_output", "communicate",
    })
    #: {ClassName: {attr: guard_lock_node}} — shared state and its guard.
    #: Writes (assign / augassign / del / mutating method call) outside a
    #: ``with <guard>`` block (or a ``holds(<guard>)`` pragma) are MTL003.
    guarded_attrs: Dict[str, Dict[str, str]] = field(default_factory=dict)
    #: methods where unguarded writes are allowed (single-threaded phases)
    init_methods: Set[str] = field(
        default_factory=lambda: {"__init__", "__new__",
                                 "_init_suggest_ahead"})
    #: receiver-name roles for cross-class call resolution:
    #: "proxy" = the server's sharded-ledger proxy (mutators acquire EXP
    #: and journal to the WAL buffer), "wal" = WriteAheadLog, "backend" =
    #: the in-memory ledger backend class.
    receiver_roles: Dict[str, str] = field(default_factory=dict)
    #: class names backing each role (resolution targets)
    wal_class: str = "WriteAheadLog"
    backend_class: str = "MemoryLedger"
    #: ledger proxy method sets (mirror _ShardedLedger; overridable)
    proxy_lock_free: FrozenSet[str] = frozenset({
        "get", "fetch", "count", "fetch_completed_since",
        "load_experiment", "list_experiments", "export_docs",
    })
    proxy_mutators: FrozenSet[str] = frozenset({
        "create_experiment", "update_experiment", "delete_experiment",
        "register", "reserve", "update_trial", "release_stale",
    })
    #: classes the bare-name fallback must never resolve into — the RPC
    #: client mirrors the LedgerBackend API by design, and resolving a
    #: server-internal backend call to the client's socket methods would
    #: manufacture phantom blocking edges
    no_fallback_classes: Set[str] = field(default_factory=set)
    #: container/stdlib method names never resolved to scanned functions
    #: (avoids ``self._pending.append`` aliasing WriteAheadLog.append)
    never_resolve: Set[str] = field(default_factory=lambda: {
        "append", "add", "get", "pop", "popleft", "update", "setdefault",
        "extend", "remove", "discard", "clear", "items", "keys",
        "values", "join", "split", "strip", "put", "get_nowait",
        "encode", "decode", "close", "copy", "sort", "insert", "count",
        "wait", "notify", "notify_all", "acquire", "release", "set",
        "is_set", "todict", "to_dict", "from_dict", "write", "read",
        "flush", "fileno",
    })

    # -- hot device functions (analysis/hotpath.py) ------------------------
    #: dotted-name tails that make the host wait for the device (MTJ003
    #: inside ``# mtpu: hotpath`` functions): PyTorch's read-backs, the
    #: explicit device barrier, Python scalar casts of a tensor, and numpy
    #: copies of one
    host_sync_calls: Set[str] = field(default_factory=lambda: {
        "item", "cpu", "tolist", "numpy", "torch.cuda.synchronize",
        "np.asarray", "np.array", "numpy.asarray", "numpy.array",
        "float", "int", "bool",
    })
    #: functions treated as hot even without a pragma ("Class.fn" or "fn")
    hotpath_registry: Set[str] = field(default_factory=set)

    # -- durability contract ----------------------------------------------
    #: ops whose dispatch branch must reach a journal call (None = read
    #: the registry from the scanned protocol module)
    journaled_ops: Optional[FrozenSet[str]] = None
    reply_journaled_ops: Optional[FrozenSet[str]] = None
    nested_journaled_ops: Optional[FrozenSet[str]] = None
    #: module basename holding the registry declarations
    protocol_module: str = "protocol.py"
    #: dispatch/handler structure in the server class
    dispatch_function: str = "_dispatch"
    dispatch_op_var: str = "op"
    journal_call_names: Set[str] = field(default_factory=lambda: {
        "_journal_mutation", "_journal_reply", "append",
    })
    journal_receivers: Set[str] = field(default_factory=lambda: {
        "_wal", "wal",
    })
    #: binary-wire op→opcode table for MTD004 (None = parse WIRE_OPCODES
    #: from whichever scanned module declares it; a scan with no
    #: declaration skips the check)
    wire_opcodes: Optional[Dict[str, int]] = None


def registry_frozensets(mod: LintModule, names: Set[str]
                        ) -> Dict[str, FrozenSet[str]]:
    """Extract ``NAME = frozenset({...})`` string-set declarations (module
    or class level) from a parsed module — used to read the protocol
    registry and the server's op sets without importing anything."""
    out: Dict[str, FrozenSet[str]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name) or tgt.id not in names:
            continue
        try:
            val = ast.literal_eval(ast.Expression(body=_strip_frozenset(
                node.value)))
        except (ValueError, SyntaxError):
            continue
        if isinstance(val, (set, frozenset, tuple, list)) and all(
                isinstance(v, str) for v in val):
            out[tgt.id] = frozenset(val)
    return out


def _strip_frozenset(node: ast.AST) -> ast.AST:
    """``frozenset({...})`` / ``frozenset((...))`` -> the inner literal."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "frozenset" and node.args):
        return node.args[0]
    return node


@dataclass
class RaceConfig:
    """Declarations specific to ``race`` (the dynamic detector and
    the MTR001 shared-attribute check). Kept separate from
    :class:`LintConfig` because the race side needs *imports* (live
    classes to hook) where lint needs only ASTs."""

    #: {ClassName: "module.path"} — classes whose instances get
    #: ``__setattr__``/``__getattribute__`` hooks under instrumentation.
    #: Monitored attrs = guarded_attrs merged down the MRO (a mixin's
    #: declarations apply to every adopter) plus ``extra_monitored``.
    monitor_modules: Dict[str, str] = field(default_factory=dict)
    #: {ClassName: {attr}} — monitored dynamically without a lint guard
    #: declaration (e.g. attrs protected by happens-before, not a lock)
    extra_monitored: Dict[str, Set[str]] = field(default_factory=dict)
    #: {(ClassName, attr)} — excluded from dynamic monitoring AND from
    #: MTR001, with the doctrine recorded here. Use sparingly.
    race_exempt: Set[Tuple[str, str]] = field(default_factory=set)
    #: extra thread-entry-point qualnames for the static shared-attribute
    #: computation, beyond the ``Thread(target=...)``/``_spawn`` targets
    #: found in the AST (RPC handlers run on connection threads; client
    #: methods run on arbitrary caller threads).
    entry_points: Set[str] = field(default_factory=set)


def default_race_config() -> RaceConfig:
    """Checked-in race-detection declarations for the port. The classes
    and exemptions are the reference's; ``TPE`` and ``GPBO`` join the
    monitored set for their device state (see :func:`default_config`).

    Exemption doctrine (each entry is a *deliberate* lock-free pattern,
    not an oversight):

    * ``CoordServer._mut`` — per-experiment mutation counters. Written
      under EXP (``_mutated`` holds the experiment lock); the delta-read
      fast path polls it lock-free as a freshness hint, tolerating a
      stale value by design (a stale read serves a slightly old delta,
      never a wrong one). GIL-atomic int store; declared for MTL003 but
      exempt from the dynamic read/write check.
    * ``WriteAheadLog._appended`` — monotone telemetry counter written
      under ``_buf_lock`` and read lock-free by ``stats()``/tests as a
      progress probe; same stale-tolerant doctrine.
    * ``WriteAheadLog._failed`` — sticky degradation flag. Writes are
      fenced under ``_cv`` (MTL003 enforces this); the ``append()`` hot
      path reads it lock-free because a stale False merely buffers one
      more record that the next sync() will reject.
    * ``WriteAheadLog._f`` — the file handle. Mutual exclusion is the
      ``_syncing`` leader flag elected under ``_cv`` (exactly one thread
      does I/O at a time); open()/close() are lifecycle phases.
    * ``CoordServer._ops`` — ops-served telemetry snapshot returned by
      ping; GIL-atomic int store, stale reads are the contract.
    * ``CoordServer._sock`` / ``_uds_sock`` / ``_threads`` /
      ``_prev_switchinterval`` / ``_wal`` — start()/stop()/recovery
      lifecycle attrs, written before serving threads exist or after
      they are joined. The static check
      accuses them because the bare-name call graph resolves any
      ``x.start()`` into ``CoordServer.start`` (and ``self._wal.append``
      counts as a container write to ``_wal``).
    * ``ShardRouter._sock`` / ``_threads`` and ``ShardSupervisor
      ._shard_ports`` / ``router`` / ``_watcher`` — the same
      start()/stop() lifecycle pattern: written before the accept /
      watcher threads exist or after they are joined; accused only via
      the bare-name ``start()`` call-graph collapse. (``ShardSupervisor
      .shard_map`` left this list when hand-off/failover started
      rewriting it from watcher/failover threads — it is now guarded by
      ``_procs_lock`` and declared so.)
    """
    rc = RaceConfig()
    rc.monitor_modules = {
        "CoordServer": "metaopt_tpu_torch.coord.server",
        "WriteAheadLog": "metaopt_tpu_torch.coord.wal",
        "CoordLedgerClient": "metaopt_tpu_torch.coord.client_backend",
        "MemoryLedger": "metaopt_tpu_torch.ledger.backends",
        "ExperimentArchive": "metaopt_tpu_torch.ledger.archive",
        "CMAES": "metaopt_tpu_torch.algo.cmaes",
        "ShardRouter": "metaopt_tpu_torch.coord.shards",
        "ShardSupervisor": "metaopt_tpu_torch.coord.shards",
        "BatchedExecutor": "metaopt_tpu_torch.executor.batched",
        "VirtualClock": "metaopt_tpu_torch.sim.clock",
        "SuggestFuser": "metaopt_tpu_torch.coord.fuser",
        # the port's device state: the hosted algorithms' CUDA buffers race
        # the fuser's bucket launches on the card
        "TPE": "metaopt_tpu_torch.algo.tpe",
        "GPBO": "metaopt_tpu_torch.algo.gp_bo",
    }
    rc.race_exempt = {
        ("CoordServer", "_mut"),
        ("CoordServer", "_ops"),
        ("CoordServer", "_sock"),
        ("CoordServer", "_uds_sock"),
        ("CoordServer", "_threads"),
        ("CoordServer", "_prev_switchinterval"),
        ("CoordServer", "_wal"),
        ("WriteAheadLog", "_appended"),
        ("WriteAheadLog", "_failed"),
        ("WriteAheadLog", "_f"),
        ("ShardRouter", "_sock"),
        ("ShardRouter", "_threads"),
        ("ShardSupervisor", "_shard_ports"),
        ("ShardSupervisor", "router"),
        ("ShardSupervisor", "_watcher"),
    }
    rc.entry_points = {
        # every RPC runs on a per-connection thread
        "CoordServer._handle",
        # WAL group commit runs on caller threads (no background thread)
        "WriteAheadLog.append", "WriteAheadLog.sync",
        # client methods run on arbitrary worker threads
        "CoordLedgerClient.worker_cycle",
        # router relays run on per-connection threads; the supervisor's
        # watcher and per-shard drain threads touch the proc bookkeeping
        "ShardRouter._serve_conn",
        "ShardSupervisor._watch",
        "ShardSupervisor._drain",
        # failover redistribution runs on its own per-dead-shard thread
        "ShardSupervisor._failover_shard",
        # a shared executor's pool evaluations run on worker threads
        "BatchedExecutor.execute_batch",
        # the fused suggest sweep runs on the server housekeeping thread,
        # racing per-experiment suggest/observe on RPC threads
        "SuggestFuser.tick",
    }
    return rc


def default_config() -> LintConfig:
    """The checked-in declarations for the port.

    Lock nodes are "ClassName.attr" (so ``MemoryLedger._lock`` and the
    server's global ``_lock`` stay distinct) plus the EXP pseudo-node for
    the per-experiment RLock family.

    Deliberately NOT in ``no_block_locks``:

    * ``CoordServer._snap_lock`` — exists to serialize snapshot file
      writes; fsync under it is its whole job.
    * ``TPE._launch_lock`` / ``GPBO._launch_lock`` — serialize a launch
      and its readback (``.cpu()`` waits for the card) by design.
    * ``WriteAheadLog._cv`` — a Condition; ``wait`` releases it, and the
      group-commit leader does its I/O under the ``_syncing`` flag, not
      under the cv.
    """
    cfg = LintConfig()
    cfg.lock_attrs = {
        "CoordServer": {
            "_lock", "_exp_locks_guard", "_snap_lock", "_sig_lock",
            "_replies_lock", "_inflight_lock", "_enc_lock",
            "_producers_guard", "_map_cv", "_tenant_lock", "_evict_lock",
        },
        "WriteAheadLog": {"_buf_lock", "_cv"},
        # the reference also names a ``_lock`` that neither package's
        # client has: per-thread sockets (``_local``) need no RPC lock
        "CoordLedgerClient": {"_caps_lock", "_live_lock", "_io_lock"},
        "MemoryLedger": {"_lock"},
        "ExperimentArchive": {"_seg_lock"},
        "_ProduceCoalescer": {"_guard"},
        "SuggestAhead": {"_ahead_lock"},
        "ShardRouter": {"_conns_lock", "_map_lock"},
        "ShardSupervisor": {"_procs_lock"},
        "BatchedExecutor": {"_tel_lock"},
        "VirtualClock": {"_lock"},
        "SuggestFuser": {"_lock"},
        # the hosted algorithms' device state (the port's own entries):
        # _kernel_lock guards the host-side snapshot, _launch_lock one
        # launch + readback on the card
        "TPE": {"_kernel_lock", "_launch_lock"},
        "GPBO": {"_kernel_lock", "_launch_lock"},
    }
    cfg.lock_factories = {
        "_exp_lock": (EXP_LOCK, ["CoordServer._exp_locks_guard"]),
        "_op_lock": (EXP_LOCK, ["CoordServer._exp_locks_guard"]),
    }
    cfg.no_block_locks = {
        EXP_LOCK,
        "CoordServer._lock",
        "CoordServer._exp_locks_guard",
        "CoordServer._sig_lock",
        "CoordServer._replies_lock",
        "CoordServer._inflight_lock",
        "CoordServer._enc_lock",
        "CoordServer._producers_guard",
        "WriteAheadLog._buf_lock",
        "MemoryLedger._lock",
        # columnar seal/decode only — pure in-memory work, no I/O under it
        "ExperimentArchive._seg_lock",
        "CoordLedgerClient._caps_lock",
        "CoordLedgerClient._live_lock",
        # both guard only in-memory container snapshots; socket shutdown /
        # proc wait / spawn all happen outside the lock
        "ShardRouter._conns_lock",
        "ShardSupervisor._procs_lock",
        # routing-table swap only; connect() happens after the snapshot
        # read releases it. (CoordServer._map_cv deliberately absent:
        # handoff_prepare WAITS on it for the in-flight drain.)
        "ShardRouter._map_lock",
        # telemetry counter increments only; the vmap launch itself runs
        # outside the lock
        "BatchedExecutor._tel_lock",
        # wire-byte counter increments only; the socket send/recv happen
        # under _lock, not under this one
        "CoordLedgerClient._io_lock",
        # tenancy map + scheduler arithmetic only (the scheduler is
        # lock-free by design and serialized entirely under this lock)
        "CoordServer._tenant_lock",
        # residency bookkeeping dicts only; evict-file I/O and the WAL
        # sync happen between acquisitions, never under it
        "CoordServer._evict_lock",
        # pure float arithmetic on the virtual "now"; a threaded server
        # on a virtual clock takes it on every time()/monotonic() read
        "VirtualClock._lock",
        # telemetry counter rollup only; snapshots, bucket launches, and
        # commits all run BEFORE the lock is taken (fuse() holds member
        # launch locks during the sweep, never the fuser's own lock)
        "SuggestFuser._lock",
    }
    cfg.guarded_attrs = {
        "CoordServer": {
            # reply cache (exactly-once): request-id -> reply
            "_replies": "CoordServer._replies_lock",
            # reply→experiment attribution (shipped with a hand-off)
            "_reply_exps": "CoordServer._replies_lock",
            "_exp_locks": "CoordServer._exp_locks_guard",
            "_signals": "CoordServer._sig_lock",
            "_inflight": "CoordServer._inflight_lock",
            "_enc_cache": "CoordServer._enc_lock",
            "_enc_hits": "CoordServer._enc_lock",
            "_producers": "CoordServer._producers_guard",
            "_coalescers": "CoordServer._producers_guard",
            # per-experiment mutation counters for the delta-read path;
            # written only while holding the experiment's lock
            "_mut": EXP_LOCK,
            # hand-off plane: the migration fence, the per-experiment
            # in-flight counts the drain waits on, and the shard map /
            # routing table the ownership commit swaps
            "_migrating": "CoordServer._map_cv",
            "_exp_inflight": "CoordServer._map_cv",
            "shard_map": "CoordServer._map_cv",
            "_ring": "CoordServer._map_cv",
            # multi-tenant service plane: experiment→tenant map + the
            # fair-produce scheduler (lock-free internally, serialized
            # here), and the residency stubs/touch-stamps/counters
            "_tenant_of": "CoordServer._tenant_lock",
            "_sched": "CoordServer._tenant_lock",
            "_evicted": "CoordServer._evict_lock",
            "_exp_last_touch": "CoordServer._evict_lock",
            "_evictions": "CoordServer._evict_lock",
            "_hydrations": "CoordServer._evict_lock",
            # incremental-snapshot state: the per-experiment section cache
            # and the segment-id → on-disk-file dedup map, touched by the
            # housekeeping snapshot and on-demand snapshot RPCs alike
            "_snap_sections": "CoordServer._snap_lock",
            "_seg_on_disk": "CoordServer._snap_lock",
        },
        "WriteAheadLog": {
            "_pending": "WriteAheadLog._buf_lock",
            "_next_seq": "WriteAheadLog._buf_lock",
            "_appended": "WriteAheadLog._buf_lock",
            "_durable": "WriteAheadLog._cv",
            "_syncing": "WriteAheadLog._cv",
            # sticky failure flag: latecomers poll it under the cv, so
            # every publication must be fenced the same way as _durable
            "_failed": "WriteAheadLog._cv",
            # batch/record telemetry incremented per group commit
            "batches": "WriteAheadLog._buf_lock",
            "records": "WriteAheadLog._buf_lock",
            # open compaction fences (hand-off tail extraction): compact()
            # polls it under the cv exactly like _syncing
            "_fence": "WriteAheadLog._cv",
            # per-thread fence depths (re-entrancy: a fence holder's own
            # compact() must not deadlock on its own fence)
            "_fence_owners": "WriteAheadLog._cv",
        },
        "CoordLedgerClient": {
            "_caps": "CoordLedgerClient._caps_lock",
            "_incarnation": "CoordLedgerClient._caps_lock",
            "_live": "CoordLedgerClient._live_lock",
            # shard-routing state learned from ping caps: the map/ring and
            # per-address incarnations are read by every routed call and
            # rewritten by ping/_after_reconnect on any thread
            "_shard_map": "CoordLedgerClient._caps_lock",
            "_ring": "CoordLedgerClient._caps_lock",
            "_shard_addrs": "CoordLedgerClient._caps_lock",
            "_incarnations": "CoordLedgerClient._caps_lock",
            # monotonic map-adoption watermark: a stale lower-version
            # ping can never roll the routing back
            "_map_version": "CoordLedgerClient._caps_lock",
            # wire-v2 telemetry: bytes on the wire including the 4-byte
            # length header, incremented per exchange from worker threads
            "bytes_sent": "CoordLedgerClient._io_lock",
            "bytes_recv": "CoordLedgerClient._io_lock",
        },
        "ShardRouter": {
            # live relay connections: accept thread adds, per-conn threads
            # remove, stop() snapshots for shutdown
            "_conns": "ShardRouter._conns_lock",
            # routing state swapped whole by update_map() (hand-off /
            # failover commits race the per-connection relay threads)
            "shard_map": "ShardRouter._map_lock",
            "_table": "ShardRouter._map_lock",
            "_addrs": "ShardRouter._map_lock",
            "_first_sid": "ShardRouter._map_lock",
        },
        "ShardSupervisor": {
            # shard bookkeeping: watcher respawns, drain threads record
            # recovery times, chaos hooks read — all cross-thread
            "_shards": "ShardSupervisor._procs_lock",
            "_all_procs": "ShardSupervisor._procs_lock",
            "recovery_times": "ShardSupervisor._procs_lock",
            # hand-off/failover: the committed map and the failover
            # telemetry are rewritten from failover threads
            "shard_map": "ShardSupervisor._procs_lock",
            "failover_times": "ShardSupervisor._procs_lock",
            "_failover_threads": "ShardSupervisor._procs_lock",
        },
        "MemoryLedger": {
            # ledger dicts + the O(1) status-count index
            "_experiments": "MemoryLedger._lock",
            "_trials": "MemoryLedger._lock",
            "_status_ids": "MemoryLedger._lock",
            "_new_heap": "MemoryLedger._lock",
            "_completed_log": "MemoryLedger._lock",
            "_exp_gen": "MemoryLedger._lock",
            # per-experiment columnar archives (completed-trial storage)
            "_archives": "MemoryLedger._lock",
        },
        "ExperimentArchive": {
            # sealed segments + mutable head + the id→position liveness
            # index: appends/seals from the ledger's write path race
            # snapshot exports and fetch materialization
            "_segments": "ExperimentArchive._seg_lock",
            "_head": "ExperimentArchive._seg_lock",
            "_head_live": "ExperimentArchive._seg_lock",
            "_head_pos": "ExperimentArchive._seg_lock",
            "_skeys": "ExperimentArchive._seg_lock",
            "_svals": "ExperimentArchive._seg_lock",
            "_odd": "ExperimentArchive._seg_lock",
            "_live_sealed": "ExperimentArchive._seg_lock",
            "_seg_seq": "ExperimentArchive._seg_lock",
        },
        "SuggestAhead": {
            # speculative-refill pool bookkeeping: the spawn decision and
            # the hit/miss/launch telemetry are touched from the caller
            # thread AND the refill thread
            "_refill_thread": "SuggestAhead._ahead_lock",
            "_ahead_hits": "SuggestAhead._ahead_lock",
            "_ahead_misses": "SuggestAhead._ahead_lock",
            "_ahead_launches": "SuggestAhead._ahead_lock",
        },
        "BatchedExecutor": {
            # row/pool telemetry: one executor may be shared by several
            # batched workers, and telemetry() reads cross-thread (the
            # port counts launches as pools: one objective call a pool)
            "_rows": "BatchedExecutor._tel_lock",
            "_pools": "BatchedExecutor._tel_lock",
        },
        "VirtualClock": {
            # the virtual "now": every server/WAL/trial time read takes
            # the lock, and a test's advance()/advance_to() races them
            # when the clock is shared with a live threaded server
            "_now": "VirtualClock._lock",
        },
        "SuggestFuser": {
            # sweep/launch/commit telemetry: the housekeeping tick thread
            # writes, tenant_stats/bench readers snapshot cross-thread
            "_ticks": "SuggestFuser._lock",
            "_bucket_launches": "SuggestFuser._lock",
            "_fused_experiments": "SuggestFuser._lock",
            "_fallback_experiments": "SuggestFuser._lock",
            "_last_buckets": "SuggestFuser._lock",
            "_last_fused": "SuggestFuser._lock",
            "_last_occupancy": "SuggestFuser._lock",
            # the port's own: bucket launches that raised on the card
            "_launch_errors": "SuggestFuser._lock",
        },
        # -- the port's device state ------------------------------------
        "TPE": {
            # the categorical table and continuous mask uploaded to the
            # card at the first EI launch, under the snapshot lock
            "_n_choices_dev": "TPE._kernel_lock",
            "_cont_mask_dev": "TPE._kernel_lock",
            # the pending-lie overlay: device copies of the buffer with
            # the lie rows, rebuilt in the snapshot when (n, pending) moves
            "_aug_key": "TPE._kernel_lock",
            "_aug_X": "TPE._kernel_lock",
            "_aug_y": "TPE._kernel_lock",
            "_aug_n": "TPE._kernel_lock",
        },
        "GPBO": {
            # the pending-lie overlay of the device factor: composed
            # OUTSIDE the snapshot lock, after the launch lock serializes
            # every factor reader and writer (_launch_ei's callers and the
            # fuser, whose non-blocking acquire holds it through commit)
            "_aug_key": "GPBO._launch_lock",
            "_aug": "GPBO._launch_lock",
        },
    }
    cfg.receiver_roles = {
        "ledger": "proxy", "_ledger": "proxy",
        "_wal": "wal", "wal": "wal",
        "_inner": "backend", "inner": "backend",
    }
    cfg.no_fallback_classes = {"CoordLedgerClient"}
    cfg.hotpath_registry = set()
    return cfg


@dataclass
class CrashConfig:
    """Declarations specific to ``crashcheck`` (the MTP persistence-
    order checkers and the crash-state enumeration suites). Same doctrine
    as :class:`LintConfig`: tests build small configs of this shape for
    fixture modules, so the checkers stay config-driven and hermetic."""

    #: module basename whose ``DURABLE_SEQUENCES`` dict literal declares
    #: the ordered-step protocols MTP003 enforces
    protocol_module: str = "protocol.py"
    #: explicit registry override (tests); None = parse the module
    durable_sequences: Optional[Dict[str, Dict[str, object]]] = None
    #: qualname prefixes of ack-publishing functions: every network send
    #: inside one must be preceded (in source order) by a WAL sync —
    #: MTP002. Prefix-matched so nested sender closures are covered.
    ack_publishers: Set[str] = field(default_factory=lambda: {
        "CoordServer._serve_conn",
    })
    #: receiver names whose ``.append``/``.sync`` are WAL journal effects
    wal_receivers: Set[str] = field(default_factory=lambda: {
        "_wal", "wal", "self._wal", "self.wal",
    })
    #: call-name tails that put ack bytes on the wire
    ack_calls: Set[str] = field(default_factory=lambda: {
        "send_payload", "send_msg", "sendall",
    })
    #: fault-arming indirection for MTP004: module-level string-constant
    #: assignments whose target name contains one of these markers count
    #: as arming every ``kind:`` spec they embed, provided the constant's
    #: NAME appears in the tests tree (tests import the spec wholesale —
    #: e.g. sim/engine.py's DEFAULT_FAULTS in test_sim_scale.py)
    fault_const_markers: Set[str] = field(default_factory=lambda: {
        "FAULTS",
    })
    #: directory scanned for fault-kind arming (None = <repo>/tests)
    tests_dir: Optional[str] = None
    #: the dotted module of the filesystem seam (``fsjournal``) whose
    #: calls are persistence effects; the reference's names its own
    seam_module: str = "metaopt_tpu_torch.utils.fsjournal"
    #: glob patterns (relative to the tests directory, ``/``-separated)
    #: of the files whose text arms a barrier; None = every ``.py`` file
    tests_patterns: Optional[Tuple[str, ...]] = None


def default_crash_config() -> CrashConfig:
    """The checked-in crashcheck declarations for the port. The tests tree
    also holds the reference's tests, so a barrier counts as armed only
    when a test the port owns names it: ``test_torch_*.py`` and the
    fixture copies under ``torch_fixtures/``."""
    return CrashConfig(tests_patterns=("test_torch_*.py", "torch_fixtures/*"))
