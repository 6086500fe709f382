"""Designated concurrency workloads for ``race`` (port of
``metaopt_tpu/analysis/suites.py``, driving the port's classes).

Each suite is a short, deterministic-in-shape (not in interleaving)
workload chosen to push the repo's real thread families through their
shared state while instrumented:

* ``coord`` — a live :class:`CoordServer` with WAL + snapshots enabled
  and aggressive housekeeping, under 8 client threads running the fused
  ``worker_cycle`` loop with deferred ``complete`` legs. Exercises
  accept/conn/sender threads, the sharded per-experiment locks, the
  reply cache, group commit, and the sweep/snapshot loop. A second
  phase drives a 2-shard :class:`ShardSupervisor`: the shard processes
  themselves are outside the instrumented interpreter, so the surface
  under test is the in-process client routing state (`_ring`,
  `_shard_addrs`, per-address incarnations under ``_caps_lock``), the
  router's connection set, and the supervisor's proc bookkeeping. A
  third phase bounces a live experiment between two shards with
  ``sup.handoff`` under concurrent writers: the client's monotonic map
  adoption + ``Migrating`` retry loop, the router's table swap under
  ``_map_lock``, and the supervisor's committed-map bookkeeping race. A
  fourth phase runs two batched workers (``workon(batch_size=...)``)
  sharing ONE :class:`BatchedExecutor` against an algorithm-hosting
  server: the fused multi-trial ``complete`` leg, the reservation race
  for pool slots, and the executor's launch telemetry under
  ``_tel_lock``. A fifth phase runs a mixed-wire fleet against one
  UDS-enabled server — a pinned-JSON client, a binary (wire v2)
  client, and a UDS-fast-path client concurrently — so the
  per-address wire/uds caches under ``_caps_lock``, the server's
  wire-keyed encode cache, and the per-connection codec detection all
  race across codecs. A sixth phase runs two weighted tenants whose
  experiment fleet is twice the server's residency budget: the
  housekeeping sweep keeps evicting LRU experiments while workers
  hydrate them back on first touch, so the tenancy map + WDRR
  scheduler under ``_tenant_lock`` and the residency bookkeeping
  (``_evicted``, ``_exp_last_touch``, eviction/hydration counters)
  under ``_evict_lock`` race the stub-indexed ``tenant_stats`` read
  path. A seventh phase turns the fused suggest plane on
  (``fuse_suggest=True`` at an aggressive tick interval) over a
  TPE-hosting fleet wider than the residency budget: the fuser's
  demand sweep (non-blocking launch-lock acquires, bucket launches,
  commit/abort) races per-experiment ``worker_cycle`` produce legs,
  the evict sweep tearing members down mid-sweep, and a
  ``tenant_stats`` prober reading the fuser telemetry under
  ``SuggestFuser._lock``.
* ``algo`` — CMA-ES (numpy-only: no compile cost inside the detector)
  with ``suggest_prefetch_depth=2``, a driver thread running
  suggest/observe generations against the SuggestAhead refill thread,
  and a prober thread hammering ``state_dict`` + telemetry — the
  workload shape that once held a MOTPE lock-order inversion.
* ``wal`` — 4 appender threads doing append+sync group commits against
  a compactor thread and a final close(), kill-free (the chaos fault
  points stay unarmed), on a real file so fsync windows are realistic.
* ``sim`` — a live threaded :class:`CoordServer` running on a shared
  :class:`VirtualClock` (the scale simulator's clock seam) under client
  worker threads, while an advancer thread pushes virtual time past
  stale-sweep expiries. The discrete-event simulator itself is
  single-threaded, but the seam is also used by tests that inject a
  virtual clock into a *started* server — so ``VirtualClock._now``
  under ``_lock`` must survive conn/housekeeping threads reading
  ``time()``/``monotonic()`` against concurrent ``advance()`` calls,
  and the sweep must keep CAS-releasing reservations whose heartbeats
  aged out in virtual (not wall) time.

Suites construct everything they touch INSIDE the instrumented region
(locks must be minted under instrumentation to be wrapped) and join all
their threads before returning — the conftest leak check and the
detector's join-edges both depend on it.

``scale`` multiplies iteration counts: 1 is the fast test
run, the ``slow``-marked chaos-length variant passes more. ``device`` is
where the algorithm-hosting servers, the shard processes and the batched
executor run (``cuda`` unless given; without CUDA they raise): on the card
the batched and fuser legs launch their pools and buckets there from
several host threads at once.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional


def suite_coord(scale: int = 1, device: Optional[str] = None) -> None:
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space

    workers = 8
    budget = workers * 6 * scale
    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "coord.snap")
        with CoordServer(snapshot_path=snap, snapshot_interval_s=0.2,
                         stale_timeout_s=5.0, sweep_interval_s=0.1,
                         device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port)
            Experiment(
                "race-coord", c0,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget, pool_size=workers,
                algorithm={"random": {"seed": 7}},
            ).configure()
            errors: List[BaseException] = []
            # odd workers share ONE client: cross-thread client state
            # (caps cache, live-reservation map, socket lock) is part of
            # the surface — benchmarks/coord_scale.py shares clients too
            shared = CoordLedgerClient(host=host, port=port)

            def worker(i: int) -> None:
                try:
                    c = (shared if i % 2
                         else CoordLedgerClient(host=host, port=port))
                    complete = None
                    for _ in range(budget * 4):
                        out = c.worker_cycle(
                            "race-coord", f"w{i}", pool_size=workers,
                            complete=complete)
                        complete = None
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= budget:
                                return
                            continue
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        complete = {"trial": t.to_dict(),
                                    "expected_status": "reserved",
                                    "expected_worker": f"w{i}"}
                except BaseException as e:  # surfaced by the runner
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-worker-{i}")
                       for i in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            if errors:
                raise errors[0]
    _coord_sharded_phase(scale, device)
    _coord_handoff_phase(scale, device)
    _coord_batched_phase(scale, device)
    _coord_mixed_wire_phase(scale, device)
    _coord_multitenant_phase(scale, device)
    _coord_fuser_phase(scale, device)
    _coord_archive_phase(scale, device)


def _coord_archive_phase(scale: int = 1,
                         device: Optional[str] = None) -> None:
    """Columnar-archive leg of the coord suite: a tiny ``segment_rows``
    makes every few completions seal a segment while the housekeeping
    loop takes incremental snapshots, so the archive's seal/append path
    (``_seg_lock`` under ``MemoryLedger._lock``) races snapshot capture
    (section cache + segment export under ``_snap_lock``), lazy batch
    materialization (``fetch_completed_since`` readers walking cursors
    across live sealing), and revivals flipping sealed rows dead from a
    worker thread."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.ledger import Experiment, Trial
    from metaopt_tpu_torch.space import build_space

    workers = 4
    budget = workers * 6 * scale
    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "coord.snap")
        with CoordServer(snapshot_path=snap, snapshot_interval_s=0.05,
                         stale_timeout_s=5.0, sweep_interval_s=0.05,
                         archive_segment_rows=4, device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port)
            Experiment(
                "race-archive", c0,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget * 2, pool_size=workers,
                algorithm={"random": {"seed": 7}},
            ).configure()
            stop = threading.Event()
            errors: List[BaseException] = []

            def worker(i: int) -> None:
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    done = 0
                    while done < budget // workers:
                        t = Trial(params={"x": float(i * 100 + done)},
                                  experiment="race-archive")
                        c.register(t)
                        got = c.reserve("race-archive", f"aw{i}")
                        if got is None:
                            continue
                        got.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (got.params["x"] - 1) ** 2,
                        }])
                        got.transition("completed")
                        if c.update_trial(got, expected_status="reserved"):
                            done += 1
                except BaseException as e:
                    errors.append(e)

            def reader() -> None:
                # cursor walker: batches materialize lazily off segments
                # that are being sealed (and snapshotted) under it
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    cur = None
                    while not stop.is_set():
                        batch, cur = c.fetch_completed_since(
                            "race-archive", cur)
                        for t in batch:
                            assert t.status == "completed"
                except BaseException as e:
                    errors.append(e)

            def reviver() -> None:
                # flip completed rows back to new (dead-row path) and let
                # the workers re-complete them
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    while not stop.is_set():
                        done = c.fetch("race-archive", "completed")
                        for t in done[:2]:
                            t.status = "new"
                            t.worker = None
                            t.results = []
                            c.update_trial(t, expected_status="completed")
                        stop.wait(0.02)
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-archive-worker-{i}")
                       for i in range(workers)]
            threads.append(threading.Thread(target=reader,
                                            name="race-archive-reader"))
            threads.append(threading.Thread(target=reviver,
                                            name="race-archive-reviver"))
            for t in threads:
                t.start()
            for t in threads[:workers]:
                t.join(timeout=120.0)
            stop.set()
            for t in threads[workers:]:
                t.join(timeout=30.0)
            if errors:
                raise errors[0]


def _coord_sharded_phase(scale: int = 1,
                         device: Optional[str] = None) -> None:
    """2-shard leg of the coord suite: worker threads route by the shard
    map through one SHARED client (the routing table, per-address socket
    map and incarnation dict race here), while an old-style client with
    pinned caps drives the router fallback path concurrently."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, ShardSupervisor
    from metaopt_tpu_torch.coord.shards import ring_of
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space

    workers = 4
    budget = workers * 3 * scale
    with ShardSupervisor(2, restart=False, device=device) as sup:
        host, port = sup.address
        # one experiment per shard, so routed traffic exercises both
        ring = ring_of(sup.shard_map)
        names: List[str] = []
        owners: set = set()
        i = 0
        while len(names) < 2:
            nm = f"race-shard{i}"
            if ring.owner(nm) not in owners:
                owners.add(ring.owner(nm))
                names.append(nm)
            i += 1
        shared = CoordLedgerClient(host=host, port=port)
        shared.ping()  # learn the map before the workers fan out
        for nm in names:
            Experiment(
                nm, shared,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget, pool_size=workers,
                algorithm={"random": {"seed": 7}},
            ).configure()
        errors: List[BaseException] = []
        stop = threading.Event()

        def worker(i: int) -> None:
            try:
                name = names[i % len(names)]
                for _ in range(budget * 4):
                    out = shared.worker_cycle(
                        name, f"sw{i}", pool_size=workers)
                    t = out["trial"]
                    if t is None:
                        if out["counts"]["completed"] >= budget:
                            return
                        continue
                    t.attach_results([{
                        "name": "objective", "type": "objective",
                        "value": (t.params["x"] - 1) ** 2,
                    }])
                    t.transition("completed")
                    shared.update_trial(
                        t, expected_status="reserved",
                        expected_worker=f"sw{i}")
            except BaseException as e:
                errors.append(e)

        # an old client never learns the map: every op relays through the
        # router (pinned caps predate the shard_map capability)
        legacy = CoordLedgerClient(host=host, port=port)
        legacy._caps = ("count", "fetch_completed_since", "worker_cycle")

        def legacy_prober() -> None:
            try:
                while not stop.is_set():
                    for nm in names:
                        legacy.count(nm, "completed")
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,),
                                    name=f"race-shard-worker-{i}")
                   for i in range(workers)]
        threads.append(threading.Thread(target=legacy_prober,
                                        name="race-shard-legacy"))
        for t in threads:
            t.start()
        for t in threads[:-1]:
            t.join(timeout=120.0)
        stop.set()
        threads[-1].join(timeout=30.0)
        if errors:
            raise errors[0]


def _coord_handoff_phase(scale: int = 1,
                         device: Optional[str] = None) -> None:
    """Live-migration leg of the coord suite: worker threads hammer ONE
    experiment through a shared routed client while the main thread
    bounces it between the two shards with ``sup.handoff``. The shard
    processes are uninstrumented; the surface under test is the client's
    monotonic map adoption (``_map_version`` under ``_caps_lock``), its
    ``Migrating``/``WrongShardError`` retry loop, the router's routing
    table swap under ``_map_lock``, and the supervisor's committed map +
    override bookkeeping under ``_procs_lock``."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, ShardSupervisor
    from metaopt_tpu_torch.coord.shards import RoutingTable
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space

    workers = 4
    budget = workers * 3 * scale
    with tempfile.TemporaryDirectory() as td:
        with ShardSupervisor(2, restart=False, device=device,
                             snapshot_dir=os.path.join(td, "snaps")) as sup:
            host, port = sup.address
            nm = "race-handoff"
            shared = CoordLedgerClient(host=host, port=port)
            shared.ping()  # learn the map before the workers fan out
            Experiment(
                nm, shared,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget, pool_size=workers,
                algorithm={"random": {"seed": 7}},
            ).configure()
            errors: List[BaseException] = []

            def worker(i: int) -> None:
                try:
                    for _ in range(budget * 6):
                        out = shared.worker_cycle(
                            nm, f"hw{i}", pool_size=workers)
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= budget:
                                return
                            continue
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        shared.update_trial(
                            t, expected_status="reserved",
                            expected_worker=f"hw{i}")
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-handoff-worker-{i}")
                       for i in range(workers)]
            for t in threads:
                t.start()
            try:
                # bounce the experiment source→dest→source while the
                # workers write through the migration fence
                sids = [s["id"] for s in sup.shard_map["shards"]]
                src = RoutingTable(sup.shard_map).owner(nm)
                dst = next(s for s in sids if s != src)
                for dest in (dst, src):
                    sup.handoff(nm, dest, drain_timeout_s=10.0,
                                window_s=30.0)
            except BaseException as e:
                errors.append(e)
            finally:
                for t in threads:
                    t.join(timeout=120.0)
            if errors:
                raise errors[0]


def _coord_batched_phase(scale: int = 1,
                         device: Optional[str] = None) -> Dict[str, Any]:
    """Batched-worker leg of the coord suite: two ``workon`` loops with
    ``batch_size=4`` share ONE :class:`BatchedExecutor` against a live
    algorithm-hosting server. The surface under test is the fused
    multi-trial ``complete`` leg (``completed_oks`` vs the reply cache),
    the cross-worker reservation race for pool slots, and the executor's
    launch/row telemetry counters under ``_tel_lock``. The objective is a
    one-line tensor expression on ``device``, so on the card both workers'
    pools launch there. Returns the executor's telemetry."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.executor import BatchedExecutor
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.worker.loop import workon

    budget = 16 * scale
    with CoordServer(host_algorithms=True, stale_timeout_s=5.0,
                     sweep_interval_s=0.1, device=device) as s:
        host, port = s.address
        c0 = CoordLedgerClient(host=host, port=port)
        c0.create_experiment({
            "name": "race-batched", "space": {"x": "uniform(-5, 5)"},
            "max_trials": budget, "pool_size": 4,
            "algorithm": {"random": {"seed": 7}},
        })
        space = build_space({"x": "uniform(-5, 5)"})
        shared_ex = BatchedExecutor(
            lambda cols: (cols["x"] - 1.0) ** 2, space, device=device)
        errors: List[BaseException] = []

        def worker(i: int) -> None:
            try:
                c = CoordLedgerClient(host=host, port=port)
                exp = Experiment("race-batched", c).configure()
                workon(exp, shared_ex, worker_id=f"bw{i}",
                       producer_mode="coord", batch_size=4,
                       max_idle_cycles=100)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,),
                                    name=f"race-batched-worker-{i}")
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        if errors:
            raise errors[0]
        return shared_ex.telemetry()


def _coord_mixed_wire_phase(scale: int = 1,
                            device: Optional[str] = None) -> None:
    """Mixed-wire leg of the coord suite: three client flavors drive one
    UDS-enabled server concurrently — one pinned to JSON (``wire="v1"``),
    one negotiating the binary wire over TCP, and one that adopts the
    advertised Unix-socket fast path. The surface under test is the
    client wire/uds caches under ``_caps_lock`` (negotiation racing the
    exchange loop), the server's wire-keyed preserialized-reply cache,
    and per-connection codec detection when frames of both formats hit
    the same ledger locks. When msgpack is absent every client degrades
    to JSON and the phase still runs as a plain 3-client workload."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.space import build_space

    flavors = 3
    budget = flavors * 4 * scale
    with tempfile.TemporaryDirectory() as td:
        uds = os.path.join(td, "coord.sock")
        with CoordServer(stale_timeout_s=5.0, sweep_interval_s=0.1,
                         uds_path=uds, device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port, wire="v1")
            Experiment(
                "race-wire", c0,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget, pool_size=flavors,
                algorithm={"random": {"seed": 7}},
            ).configure()
            clients = [
                CoordLedgerClient(host=host, port=port, wire="v1"),
                CoordLedgerClient(host=host, port=port, wire="auto"),
                CoordLedgerClient(host=host, port=port, wire="auto"),
            ]
            clients[2].ping()  # learn uds_path before the fan-out
            errors: List[BaseException] = []

            def worker(i: int) -> None:
                try:
                    c = clients[i]
                    complete = None
                    for _ in range(budget * 4):
                        out = c.worker_cycle(
                            "race-wire", f"mw{i}", pool_size=flavors,
                            complete=complete)
                        complete = None
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= budget:
                                return
                            continue
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        complete = {"trial": t.to_dict(),
                                    "expected_status": "reserved",
                                    "expected_worker": f"mw{i}"}
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-wire-{i}")
                       for i in range(flavors)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            if errors:
                raise errors[0]


def _coord_multitenant_phase(scale: int = 1,
                             device: Optional[str] = None) -> None:
    """Multi-tenant leg of the coord suite: two weighted tenants own
    four experiments against a server whose residency budget
    (``max_resident=2``) is half the fleet, so the housekeeping sweep
    keeps evicting the LRU experiments while each worker's next touch
    hydrates its own back. The surface under test is the tenancy map +
    weighted deficit-round-robin arithmetic under ``_tenant_lock``
    (produce legs from both tenants racing the window roll), the
    residency bookkeeping (``_evicted`` stub index, ``_exp_last_touch``,
    eviction/hydration counters) under ``_evict_lock`` racing the sweep
    loop, and the stub-indexed ``tenant_stats`` read path — a prober
    thread hammers it with ``include_experiments=True`` against live
    evictions, which must never hydrate."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer

    tenants = ("mt-a", "mt-b")
    per_exp = 6 * scale
    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "coord.snap")
        with CoordServer(snapshot_path=snap, stale_timeout_s=5.0,
                         sweep_interval_s=0.1, max_resident=2,
                         tenant_weights={"mt-a": 2.0, "mt-b": 1.0},
                         device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port)
            names = []
            for k in range(4):
                nm = f"race-mt-{k}"
                c0.create_experiment({
                    "name": nm, "tenant": tenants[k % 2],
                    "space": {"x": "uniform(-5, 5)"},
                    "max_trials": per_exp, "pool_size": 2,
                    "algorithm": {"random": {"seed": 7 + k}},
                })
                names.append(nm)
            stop = threading.Event()
            errors: List[BaseException] = []

            def prober() -> None:
                # the no-hydrate status scan racing live evictions: the
                # stub index must answer without resurrecting anything
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    while not stop.is_set():
                        st = c.tenant_stats(include_experiments=True)
                        if set(st["experiments"]) != set(names):
                            raise AssertionError(
                                f"status scan lost experiments: {st}")
                except BaseException as e:
                    errors.append(e)

            def worker(i: int) -> None:
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    nm = names[i]
                    complete = None
                    for _ in range(per_exp * 12):
                        out = c.worker_cycle(
                            nm, f"mtw{i}", pool_size=2, complete=complete)
                        complete = None
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= per_exp:
                                return
                            continue
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        complete = {"trial": t.to_dict(),
                                    "expected_status": "reserved",
                                    "expected_worker": f"mtw{i}"}
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-mt-worker-{i}")
                       for i in range(4)]
            p = threading.Thread(target=prober, name="race-mt-prober")
            p.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            stop.set()
            p.join(timeout=30.0)
            if errors:
                raise errors[0]


#: the fuser leg's trial time: ten 20 ms sweep intervals, so that sweeps find
#: members idle with demand (``chip_smoke.py``'s [analysis] checks it fused)
_FUSE_TRIAL_S = 0.2


def _coord_fuser_phase(scale: int = 1,
                       device: Optional[str] = None) -> Dict[str, Any]:
    """Fused-suggest leg of the coord suite: the fuser's demand sweep
    (housekeeping-adjacent ``coord-fuser`` thread) against a TPE-hosting
    fleet wider than the residency budget. The surface under test is the
    fuser tick racing per-experiment produce legs for each member's
    launch lock (non-blocking acquire → snapshot → bucket launch →
    commit/abort), the evict sweep tearing members down between the
    sweep's lock hand-offs, and the telemetry rollup under
    ``SuggestFuser._lock`` racing a ``tenant_stats`` prober. TPE's
    ``n_initial_points`` is small so the EI path (the only fusable
    phase) engages within the budget. Each trial "runs" for
    ``_FUSE_TRIAL_S`` while four-wide produce legs drain one-point pools,
    so the sweep finds members with demand and a free launch lock and
    buckets launch (the reference's instant trials, two-wide produce legs
    and four-point pools leave the speculative refill holding every
    launch lock, and its leg fuses nothing in most runs). The hosted TPEs
    run on ``device``:
    on the card the buckets launch there, racing the members' own EI
    launches on the RPC threads. Returns the fuser's telemetry."""
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer

    per_exp = 8 * scale
    with tempfile.TemporaryDirectory() as td:
        with CoordServer(evict_dir=os.path.join(td, "evict"),
                         stale_timeout_s=5.0, sweep_interval_s=0.1,
                         max_resident=3, fuse_suggest=True,
                         fuse_interval_s=0.02, fuse_bucket_max=4,
                         device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port)
            names = []
            for k in range(4):
                nm = f"race-fuse-{k}"
                c0.create_experiment({
                    "name": nm,
                    "space": {"x": "uniform(-5, 5)"},
                    "max_trials": per_exp, "pool_size": 4,
                    "algorithm": {"tpe": {
                        "seed": 17 + k, "n_initial_points": 2,
                        "pool_prefetch": 1,
                    }},
                })
                names.append(nm)
            stop = threading.Event()
            errors: List[BaseException] = []

            def prober() -> None:
                # fuser telemetry rollup racing live sweeps + evictions
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    last = -1
                    while not stop.is_set():
                        st = c.tenant_stats()
                        fu = st.get("fuser")
                        if fu is not None:
                            if fu["ticks"] < last:
                                raise AssertionError(
                                    f"fuser tick count regressed: {fu}")
                            last = fu["ticks"]
                except BaseException as e:
                    errors.append(e)

            def worker(i: int) -> None:
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    nm = names[i]
                    complete = None
                    for _ in range(per_exp * 12):
                        out = c.worker_cycle(
                            nm, f"fw{i}", pool_size=4, complete=complete)
                        complete = None
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= per_exp:
                                return
                            continue
                        stop.wait(_FUSE_TRIAL_S)  # the trial "runs"
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        complete = {"trial": t.to_dict(),
                                    "expected_status": "reserved",
                                    "expected_worker": f"fw{i}"}
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-fuse-worker-{i}")
                       for i in range(4)]
            p = threading.Thread(target=prober, name="race-fuse-prober")
            p.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180.0)
            stop.set()
            p.join(timeout=30.0)
            if errors:
                raise errors[0]
            return s._fuser.telemetry()


def suite_algo(scale: int = 1, device: Optional[str] = None) -> None:
    from metaopt_tpu_torch.algo import CMAES
    from metaopt_tpu_torch.ledger.trial import Trial
    from metaopt_tpu_torch.space import build_space

    space = build_space({"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"})
    algo = CMAES(space, seed=11, population_size=6,
                 suggest_prefetch_depth=2)
    stop = threading.Event()
    errors: List[BaseException] = []

    def prober() -> None:
        # a MOTPE lock-order inversion once lived exactly here: state_dict
        # racing the speculative refill thread's lock acquisitions
        try:
            while not stop.is_set():
                algo.state_dict()
                algo.suggest_ahead_telemetry()
        except BaseException as e:
            errors.append(e)

    p = threading.Thread(target=prober, name="race-prober")
    p.start()
    try:
        for gen in range(8 * scale):
            pts = algo.suggest(6)
            if not pts:
                break
            trials = []
            for pt in pts:
                t = Trial(params=pt, experiment="race-algo")
                t.lineage = space.hash_point(pt)
                t.transition("reserved")
                t.attach_results([{
                    "name": "o", "type": "objective",
                    "value": (pt["x"] - 1.0) ** 2 + (pt["y"] + 2.0) ** 2,
                }])
                t.transition("completed")
                trials.append(t)
            algo.observe(trials)
    finally:
        stop.set()
        p.join(timeout=30.0)
        algo.drain_suggest_ahead()
    if errors:
        raise errors[0]


def suite_wal(scale: int = 1, device: Optional[str] = None) -> None:
    from metaopt_tpu_torch.coord.wal import WriteAheadLog

    per_thread = 25 * scale
    with tempfile.TemporaryDirectory() as td:
        wal = WriteAheadLog(os.path.join(td, "race.wal")).open()
        stop = threading.Event()
        errors: List[BaseException] = []

        def appender(i: int) -> None:
            try:
                for n in range(per_thread):
                    seq = wal.append({"op": "race", "w": i, "n": n})
                    wal.sync(seq)
            except BaseException as e:
                errors.append(e)

        def compactor() -> None:
            try:
                while not stop.is_set():
                    wal.compact(upto_seq=max(0, wal.durable_seq - 20))
                    stop.wait(0.01)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=appender, args=(i,),
                                    name=f"race-wal-{i}") for i in range(4)]
        threads.append(threading.Thread(target=compactor,
                                        name="race-wal-compact"))
        for t in threads:
            t.start()
        for t in threads[:-1]:
            t.join(timeout=60.0)
        stop.set()
        threads[-1].join(timeout=30.0)
        wal.close()
        if errors:
            raise errors[0]


def suite_sim(scale: int = 1, device: Optional[str] = None) -> None:
    from metaopt_tpu_torch.coord import CoordLedgerClient, CoordServer
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.ledger.trial import set_trial_clock
    from metaopt_tpu_torch.sim.clock import VirtualClock
    from metaopt_tpu_torch.space import build_space

    workers = 4
    budget = workers * 4 * scale
    clk = VirtualClock()
    prev = set_trial_clock(clk)
    try:
        # generous VIRTUAL stale timeout: the advancer moves ~1 virtual
        # second per 5 real ms, so expiries fire but in-flight trials
        # usually finish first — both the sweep-release and the happy
        # path get exercised
        with CoordServer(host_algorithms=True, stale_timeout_s=60.0,
                         sweep_interval_s=1.0, clock=clk,
                         device=device) as s:
            host, port = s.address
            c0 = CoordLedgerClient(host=host, port=port)
            Experiment(
                "race-sim", c0,
                space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=budget, pool_size=workers,
                algorithm={"random": {"seed": 7}},
            ).configure()
            stop = threading.Event()
            errors: List[BaseException] = []

            def advancer() -> None:
                # the simulator's event loop, compressed: advance races
                # every time()/monotonic() read on conn + sweep threads
                try:
                    while not stop.is_set():
                        clk.advance(1.0)
                        clk.advance_to(clk.monotonic())
                        stop.wait(0.005)
                except BaseException as e:
                    errors.append(e)

            def worker(i: int) -> None:
                try:
                    c = CoordLedgerClient(host=host, port=port)
                    complete = None
                    for _ in range(budget * 6):
                        out = c.worker_cycle(
                            "race-sim", f"vw{i}", pool_size=workers,
                            complete=complete)
                        complete = None
                        t = out["trial"]
                        if t is None:
                            if out["counts"]["completed"] >= budget:
                                return
                            continue
                        t.attach_results([{
                            "name": "objective", "type": "objective",
                            "value": (t.params["x"] - 1) ** 2,
                        }])
                        t.transition("completed")
                        complete = {"trial": t.to_dict(),
                                    "expected_status": "reserved",
                                    "expected_worker": f"vw{i}"}
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,),
                                        name=f"race-sim-worker-{i}")
                       for i in range(workers)]
            adv = threading.Thread(target=advancer, name="race-sim-adv")
            adv.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            stop.set()
            adv.join(timeout=30.0)
            if errors:
                raise errors[0]
    finally:
        set_trial_clock(prev)


SUITES: Dict[str, Callable[[int, Optional[str]], None]] = {
    "coord": suite_coord,
    "algo": suite_algo,
    "wal": suite_wal,
    "sim": suite_sim,
}
