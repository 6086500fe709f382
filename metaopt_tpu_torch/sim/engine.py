"""The discrete-event engine: simulated workers, real coordinator (port of
``metaopt_tpu/sim/engine.py``).

Architecture
------------
One :class:`VirtualClock` is shared by the CoordServer, its WAL, the
ledger backend, and Trial stamping (``set_trial_clock``). The engine
owns an event heap keyed ``(virtual_time, seq)``; popping an event
advances the clock to its time, so every component sees a coherent
"now" per event — a simulated hour of heartbeats costs microseconds.

Simulated workers speak the REAL ``worker_cycle`` protocol. The server
is constructed but never ``start()``-ed (no sockets, no threads): each
RPC is one ``server._handle(msg)`` call followed by the same durability
barrier the connection sender thread enforces —
``wal.sync(server._barrier_seq(op))`` BEFORE the reply counts as
acknowledged. Everything behind ``_handle`` is production code: the
reply cache, WAL journaling, hosted ASHA/hyperband/BOHB producers, the
fair produce scheduler, snapshots via ``housekeeping_step()`` driven on
the virtual schedule.

Fault schedule (a private :class:`FaultInjector`, seeded ``p=`` rules
from ``executor/faults.py``):

- ``sim_worker_death``   consulted per reservation; the worker dies
  holding it (stale → swept → re-served), revives after a cool-down;
- ``sim_lost_heartbeat`` consulted per reservation; the worker stops
  heartbeating but still completes LATE — its CAS'd completion must be
  rejected if the sweep re-issued the trial (delayed completions);
- ``sim_delay``          consulted per reservation; the trial becomes a
  straggler (duration × ``straggler_scale``);
- ``sim_crash_server``   consulted at every durability barrier; the
  write IS durable, the ack is lost: the coordinator is abandoned
  mid-flight, recovered from snapshot+WAL, and the worker's retry (same
  request id) must be answered from the journaled reply cache.

Certification happens at the end of :meth:`Simulation.run`: promotion
invariants over the hosted algorithm instances (``sim/certify.py``),
zero acked-write loss re-checked after every recovery AND at the end,
Jain fairness over per-tenant completions, and recovery wall-time
normalized per 10k WAL records.

Determinism contract: with a fixed :class:`SimConfig` (seed included)
the event log is byte-identical across runs. Nothing in the simulated
state may derive from the real clock or unseeded randomness — wall
times appear only in the report (recovery timing), never in the log.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
import os
import shutil
import tempfile
import time as _wall
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from metaopt_tpu_torch.benchmark.tasks import task_registry
from metaopt_tpu_torch.coord.server import CoordServer
from metaopt_tpu_torch.coord.tenancy import jain_index
from metaopt_tpu_torch.coord.wal import read_records
from metaopt_tpu_torch.executor.faults import FaultInjector
from metaopt_tpu_torch.ledger.trial import Trial, set_trial_clock
from metaopt_tpu_torch.sim.certify import promotion_violations
from metaopt_tpu_torch.sim.clock import VirtualClock

#: default fault schedule for ``simulate``: light probabilistic
#: chaos plus two deterministic coordinator crashes at ack barriers
DEFAULT_FAULTS = ("sim_worker_death:p=0.002@1,sim_lost_heartbeat:p=0.01@2,"
                  "sim_delay:p=0.02@3,sim_crash_server:2@40")


@dataclass
class SimConfig:
    """One simulated scenario; every field feeds the determinism hash."""

    workers: int = 1000
    tenants: int = 4
    experiments_per_tenant: int = 2
    algos: Tuple[str, ...] = ("asha",)
    task: str = "sphere"
    max_trials: int = 64
    pool_size: int = 8
    seed: int = 0
    faults: str = ""              # FaultInjector spec; "" = no faults
    # virtual-time knobs
    duration_mean_s: float = 30.0
    duration_sigma: float = 0.8
    straggler_p: float = 0.05
    straggler_alpha: float = 1.5
    straggler_scale: float = 8.0
    heartbeat_interval_s: float = 10.0
    stale_timeout_s: float = 45.0
    sweep_interval_s: float = 5.0
    snapshot_interval_s: float = 120.0
    # idle workers quadruple their poll interval up to the cap: at 100k
    # workers contending for a few thousand trials, dispatch volume is
    # workers × virtual_duration / cap — the cap is the knob that keeps
    # the certification run inside its five-minute wall budget
    backoff_base_s: float = 2.0
    backoff_cap_s: float = 512.0
    spread_s: float = 1.0         # initial cycle jitter window
    revive_after_s: float = 120.0
    max_virtual_s: float = 7200.0
    # durability: sync-to-file without fsync — a sim "crash" abandons the
    # process state, not the OS page cache, so write+flush is the exact
    # durability boundary; the real-fsync path is covered by the chaos
    # crash tests (tests/functional/test_coord_crash.py lineage)
    wal_fsync: bool = False
    event_log: Optional[str] = None
    workdir: Optional[str] = None

    def describe(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["algos"] = list(self.algos)
        return d


@dataclass
class SimReport:
    """What one run certifies; ``ok`` is the headline verdict."""

    config: Dict[str, Any] = field(default_factory=dict)
    experiments: int = 0
    virtual_s: float = 0.0
    wall_s: float = 0.0
    dispatches: int = 0
    trials_completed: int = 0
    acked_completions: int = 0
    cas_rejected_completions: int = 0
    stale_released: int = 0
    worker_deaths: int = 0
    crashes: int = 0
    completed_by_tenant: Dict[str, int] = field(default_factory=dict)
    jain: float = 1.0
    promotion_violations: List[str] = field(default_factory=list)
    acked_write_losses: List[str] = field(default_factory=list)
    exactly_once_violations: List[str] = field(default_factory=list)
    recoveries: List[Dict[str, float]] = field(default_factory=list)
    recovery_s_per_10k_wal: Optional[float] = None
    best_by_experiment: Dict[str, float] = field(default_factory=dict)
    event_lines: int = 0
    event_log_sha256: str = ""

    @property
    def ok(self) -> bool:
        return not (self.promotion_violations or self.acked_write_losses
                    or self.exactly_once_violations)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["ok"] = self.ok
        return d


class _SimWorker:
    __slots__ = ("name", "tenant", "experiment", "dead", "finished",
                 "trial", "hb_ok", "pending", "backoff", "last_counts",
                 "last_passive", "run_seq")

    def __init__(self, name: str, tenant: str, experiment: str) -> None:
        self.name = name
        self.tenant = tenant
        self.experiment = experiment
        self.dead = False
        self.finished = False
        self.trial: Optional[Dict[str, Any]] = None  # doc being "run"
        self.hb_ok = True
        self.pending: Optional[Dict[str, Any]] = None  # deferred complete
        self.backoff = 0.0
        self.last_counts: Optional[Dict[str, int]] = None
        self.last_passive = False
        #: bumped on every reservation; stale complete/heartbeat events
        #: from a previous run of this worker compare against it
        self.run_seq = 0


class Simulation:
    """Run one configured scenario to quiescence and certify it.

    ``device`` is where the coordinator hosts the algorithms whose
    constructor takes one (TPE, BOHB, MOTPE, GP-BO): ``cuda`` unless the
    caller says otherwise, and without CUDA the run raises instead of
    hosting on the CPU. It is resolved here, before any state is made.
    It is no part of :class:`SimConfig`: the event log and the digest do
    not depend on it.
    """

    def __init__(self, cfg: SimConfig, device: Any = None) -> None:
        from metaopt_tpu_torch.utils.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(cfg.seed)
        self.faults = FaultInjector(spec=cfg.faults or "")
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._eseq = 0
        self._reqno = 0
        self._log: List[str] = []
        self.server: Optional[CoordServer] = None
        self._workdir: Optional[str] = None
        self._own_workdir = False
        #: (experiment, trial_id) → objective for every ACKED completion —
        #: the zero-loss ledger the durability certification checks against
        self._acked: Dict[Tuple[str, str], float] = {}
        self._tasks: Dict[str, Any] = {}
        self._exp_algo: Dict[str, str] = {}
        self._exp_tenant: Dict[str, str] = {}
        self._done_exps: set = set()
        self.report = SimReport(config=cfg.describe())

    # -- plumbing ---------------------------------------------------------
    def _push(self, t: float, kind: str, payload: Any) -> None:
        self._eseq += 1
        heapq.heappush(self._heap, (t, self._eseq, kind, payload))

    def _emit(self, ev: str, **kv: Any) -> None:
        kv["t"] = round(self.clock.monotonic(), 6)
        kv["ev"] = ev
        self._log.append(json.dumps(kv, sort_keys=True,
                                    separators=(",", ":")))

    def _next_req(self) -> str:
        self._reqno += 1
        return f"sim-{self._reqno:x}"

    # -- coordinator lifecycle -------------------------------------------
    def _snapshot_path(self) -> str:
        assert self._workdir is not None
        return os.path.join(self._workdir, "coord.snap")

    def _boot_server(self) -> None:
        """Construct + recover a coordinator; never ``start()`` — no
        sockets, no threads, so dispatch is synchronous and the conftest
        thread-leak fence never sees a ``coord-*`` thread."""
        srv = CoordServer(
            snapshot_path=self._snapshot_path(),
            snapshot_interval_s=self.cfg.snapshot_interval_s,
            stale_timeout_s=self.cfg.stale_timeout_s,
            sweep_interval_s=self.cfg.sweep_interval_s,
            host_algorithms=True,
            produce_coalesce_ms=0.0,
            wal_fsync=self.cfg.wal_fsync,
            wal_group_ms=0.0,
            clock=self.clock,
            device=self.device,
        )
        srv._recover()
        self.server = srv

    def _crash_and_recover(self) -> None:
        """kill -9 semantics: drop the server object (buffered-unsynced
        WAL records die with it), then boot a successor from
        snapshot + WAL and certify no acked write was lost."""
        srv = self.server
        assert srv is not None
        wal_path = srv.wal_path
        if srv._wal is not None:
            try:
                srv._wal._f.close()  # release the fd; pending buffer lost
            except (OSError, AttributeError):
                pass
        self.server = None
        wal_records = 0
        if wal_path and os.path.exists(wal_path):
            try:
                records, _torn = read_records(wal_path)
                wal_records = len(records)
            except (OSError, ValueError):
                wal_records = 0
        t0 = _wall.perf_counter()
        self._boot_server()
        wall = _wall.perf_counter() - t0
        self.report.crashes += 1
        self.report.recoveries.append(
            {"wal_records": wal_records, "wall_s": round(wall, 6)})
        self._emit("crash_recover", wal_records=wal_records)
        self._check_acked_writes(after="recovery")

    def _check_acked_writes(self, after: str) -> None:
        srv = self.server
        assert srv is not None
        for (exp, tid) in self._acked:
            t = srv.inner.get(exp, tid)
            if t is None or t.status != "completed":
                self.report.acked_write_losses.append(
                    f"{exp}/{tid}: acked completion "
                    f"{'missing' if t is None else t.status!r} after {after}")

    # -- RPC with the sender-thread durability barrier --------------------
    @staticmethod
    def _unwrap(reply: Any) -> Any:
        """Strip the ``{"ok": ..., "result"/"error": ...}`` envelope that
        ``_handle`` produces (the wire layer's job in a real deployment)."""
        if isinstance(reply, dict) and "ok" in reply:
            if reply.get("ok"):
                return reply.get("result")
            return {"error": reply.get("error"), "msg": reply.get("msg")}
        return reply

    def _rpc(self, op: str, args: Dict[str, Any],
             req: Optional[str] = None) -> Any:
        srv = self.server
        assert srv is not None
        msg: Dict[str, Any] = {"op": op, "args": args}
        if req is not None:
            msg["req"] = req
        reply = self._unwrap(srv._handle(msg))
        self.report.dispatches += 1
        barrier = srv._barrier_seq(op)
        if barrier and srv._wal is not None:
            srv._wal.sync(barrier)
            if self.faults.fire("sim_crash_server"):
                # the write is durable, the ack never arrives: crash,
                # recover, retry the SAME request id — exactly-once says
                # the journaled reply cache must answer it identically
                original = reply
                self._crash_and_recover()
                retry = self._unwrap(
                    self.server._handle(msg))  # type: ignore[union-attr]
                self.report.dispatches += 1
                b2 = self.server._barrier_seq(op)
                if b2 and self.server._wal is not None:
                    self.server._wal.sync(b2)
                if req is not None and isinstance(original, dict) \
                        and isinstance(retry, dict):
                    for key in ("completed_ok", "completed_oks"):
                        if original.get(key) != retry.get(key):
                            self.report.exactly_once_violations.append(
                                f"req {req}: retry {key} "
                                f"{retry.get(key)!r} != original "
                                f"{original.get(key)!r}")
                    ot, rt = original.get("trial"), retry.get("trial")
                    if (ot or {}).get("id") != (rt or {}).get("id"):
                        self.report.exactly_once_violations.append(
                            f"req {req}: retry reserved "
                            f"{(rt or {}).get('id')!r} != original "
                            f"{(ot or {}).get('id')!r}")
                reply = retry
        return reply

    # -- scenario setup ---------------------------------------------------
    def _fidelity_spec(self) -> str:
        return "fidelity(1, 16, base=4)"  # rungs [1, 4, 16], eta=4

    def _make_experiments(self) -> List[_SimWorker]:
        cfg = self.cfg
        algos = list(cfg.algos) or ["asha"]
        exp_names: List[str] = []
        for ti in range(cfg.tenants):
            tenant = f"t{ti}"
            for ei in range(cfg.experiments_per_tenant):
                algo = algos[(ti * cfg.experiments_per_tenant + ei)
                             % len(algos)]
                name = f"sim-{tenant}-{algo}-{ei}"
                task = task_registry.get(cfg.task)()
                space = dict(task.space)
                if algo in ("asha", "hyperband", "bohb", "dehb"):
                    space["epochs"] = self._fidelity_spec()
                doc = {
                    "name": name,
                    "space": space,
                    "algorithm": {algo: {"seed": cfg.seed * 1009 + ti * 31
                                         + ei}},
                    "max_trials": cfg.max_trials,
                    "pool_size": cfg.pool_size,
                    "tenant": tenant,
                    "metadata": {}, "user_args": [], "version": 1,
                }
                self._rpc("create_experiment", {"config": doc},
                          req=self._next_req())
                self._tasks[name] = task
                self._exp_algo[name] = algo
                self._exp_tenant[name] = tenant
                exp_names.append(name)
                self._emit("create_experiment", exp=name, algo=algo,
                           tenant=tenant)
        self.report.experiments = len(exp_names)
        # workers round-robin over tenants, then over the tenant's
        # experiments — every tenant gets an equal worker share
        workers: List[_SimWorker] = []
        per_tenant: Dict[str, int] = {}
        for wi in range(cfg.workers):
            ti = wi % cfg.tenants
            tenant = f"t{ti}"
            k = per_tenant.get(tenant, 0)
            per_tenant[tenant] = k + 1
            mine = [n for n in exp_names
                    if self._exp_tenant[n] == tenant]
            workers.append(
                _SimWorker(f"w{wi}", tenant, mine[k % len(mine)]))
        return workers

    # -- trial physics ----------------------------------------------------
    def _draw_duration(self) -> float:
        cfg = self.cfg
        d = float(self.rng.lognormal(
            mean=math.log(cfg.duration_mean_s), sigma=cfg.duration_sigma))
        if self.rng.random() < cfg.straggler_p:
            d *= 1.0 + float(self.rng.pareto(cfg.straggler_alpha)) \
                * cfg.straggler_scale
        return max(1e-3, d)

    def _objective(self, exp: str, params: Dict[str, Any]) -> float:
        task = self._tasks[exp]
        pt = {k: v for k, v in params.items() if k != "epochs"}
        base = float(task(pt)[0]["value"])
        budget = float(params.get("epochs", 1) or 1)
        # deterministic fidelity refinement: higher budgets converge on
        # the true value, so promotion ordering is budget-consistent
        return base * (1.0 + 0.25 / max(1.0, budget))

    def _exp_done(self, reply: Dict[str, Any]) -> bool:
        counts = reply.get("counts") or {}
        max_trials = reply.get("max_trials")
        if (max_trials is not None
                and counts.get("completed", 0) >= max_trials):
            return True
        return bool(reply.get("exp_algo_done")) and (
            counts.get("new", 0) == 0 and counts.get("reserved", 0) == 0)

    # -- event handlers ---------------------------------------------------
    def _ev_cycle(self, w: _SimWorker) -> None:
        if w.dead or w.finished:
            return
        if w.experiment in self._done_exps and w.pending is None:
            w.finished = True
            return
        cfg = self.cfg
        args: Dict[str, Any] = {
            "experiment": w.experiment, "worker": w.name,
            "pool_size": cfg.pool_size,
        }
        # mirror worker/loop.py: a passive algorithm with a provably
        # exhausted registration budget gets produce=False (cheap cycle)
        produce = True
        if (w.last_passive and w.last_counts is not None):
            mt = cfg.max_trials
            c = w.last_counts
            produce = (c.get("new", 0) + c.get("reserved", 0)
                       + c.get("completed", 0)) < mt
        args["produce"] = produce
        pushed = w.pending
        if pushed is not None:
            args["complete"] = {
                "trial": pushed["doc"],
                "expected_status": "reserved",
                "expected_worker": w.name,
            }
        reply = self._rpc("worker_cycle", args, req=self._next_req())
        if not isinstance(reply, dict) or reply.get("error"):
            err = (reply or {}).get("error") if isinstance(reply, dict) \
                else type(reply).__name__
            if err == "Migrating":  # retryable fence; try again shortly
                self._push(self.clock.monotonic() + 0.1, "cycle", w)
                return
            raise RuntimeError(
                f"worker_cycle failed for {w.name}: {err}")
        if pushed is not None:
            w.pending = None
            ok = bool(reply.get("completed_ok"))
            exp, tid = w.experiment, pushed["doc"]["id"]
            if pushed.get("kind") == "suspended":
                self._emit("suspend_parked", exp=exp, trial=tid,
                           worker=w.name, ok=ok)
            elif ok:
                obj = pushed["objective"]
                self._acked[(exp, tid)] = obj
                self.report.acked_completions += 1
                tc = self.report.completed_by_tenant
                tc[w.tenant] = tc.get(w.tenant, 0) + 1
                best = self.report.best_by_experiment.get(exp)
                if best is None or obj < best:
                    self.report.best_by_experiment[exp] = obj
                self._emit("complete_ack", exp=exp, trial=tid,
                           worker=w.name, objective=round(obj, 9))
            else:
                # delayed completion: the sweep re-issued this trial to
                # another worker while we were silent — CAS must reject
                self.report.cas_rejected_completions += 1
                self._emit("complete_rejected", exp=exp, trial=tid,
                           worker=w.name)
        w.last_counts = reply.get("counts")
        w.last_passive = bool(reply.get("algo_passive"))
        self.report.stale_released += int(reply.get("released") or 0)
        doc = reply.get("trial")
        if doc is not None:
            w.backoff = 0.0
            w.run_seq += 1
            w.trial = doc
            now = self.clock.monotonic()
            self._emit("reserve", exp=w.experiment, trial=doc["id"],
                       worker=w.name)
            if reply.get("suspend"):
                t = Trial.from_dict(doc)
                t.transition("suspended")
                w.pending = {"doc": t.to_dict(), "objective": 0.0,
                             "kind": "suspended"}
                w.trial = None
                self._push(now, "cycle", w)
                return
            if self.faults.fire("sim_worker_death"):
                w.dead = True
                w.trial = None
                self.report.worker_deaths += 1
                self._emit("worker_death", worker=w.name,
                           exp=w.experiment, trial=doc["id"])
                self._push(now + cfg.revive_after_s, "revive", w)
                return
            w.hb_ok = not self.faults.fire("sim_lost_heartbeat")
            dur = self._draw_duration()
            if self.faults.fire("sim_delay"):
                dur *= cfg.straggler_scale
            self._push(now + dur, "complete", (w, w.run_seq))
            if w.hb_ok and dur > cfg.heartbeat_interval_s:
                self._push(now + cfg.heartbeat_interval_s, "heartbeat",
                           (w, w.run_seq))
            return
        # no work granted
        if self._exp_done(reply):
            if w.experiment not in self._done_exps:
                self._done_exps.add(w.experiment)
                self._emit("experiment_done", exp=w.experiment,
                           completed=(reply.get("counts") or {})
                           .get("completed"))
            w.finished = True
            return
        w.backoff = min(max(cfg.backoff_base_s, w.backoff * 4.0),
                        cfg.backoff_cap_s)
        jitter = 0.5 + float(self.rng.random())
        self._push(self.clock.monotonic() + w.backoff * jitter, "cycle", w)

    def _ev_complete(self, w: _SimWorker, run_seq: int) -> None:
        if w.dead or w.trial is None or w.run_seq != run_seq:
            return
        doc = w.trial
        w.trial = None
        t = Trial.from_dict(doc)
        obj = self._objective(w.experiment, t.params)
        t.attach_results([{"name": "objective", "type": "objective",
                           "value": obj}])
        t.transition("completed")  # stamps end_time from the virtual clock
        self.report.trials_completed += 1
        w.pending = {"doc": t.to_dict(), "objective": obj}
        self._push(self.clock.monotonic(), "cycle", w)

    def _ev_heartbeat(self, w: _SimWorker, run_seq: int) -> None:
        if w.dead or w.trial is None or w.run_seq != run_seq \
                or not w.hb_ok:
            return
        reply = self._rpc("heartbeat", {
            "experiment": w.experiment, "trial_id": w.trial["id"],
            "worker": w.name,
        })
        if isinstance(reply, dict) and not reply.get("ours", True):
            # reservation lost (swept + re-issued); keep running — the
            # eventual completion exercises the delayed-CAS rejection
            self._emit("heartbeat_lost", exp=w.experiment,
                       trial=w.trial["id"], worker=w.name)
            w.hb_ok = False
            return
        self._push(self.clock.monotonic() + self.cfg.heartbeat_interval_s,
                   "heartbeat", (w, run_seq))

    def _ev_revive(self, w: _SimWorker) -> None:
        if w.finished:
            return
        w.dead = False
        w.trial = None
        w.pending = None
        w.backoff = 0.0
        self._emit("worker_revive", worker=w.name)
        self._push(self.clock.monotonic(), "cycle", w)

    def _ev_housekeep(self, _: Any) -> None:
        assert self.server is not None
        self.server.housekeeping_step()
        if len(self._done_exps) < self.report.experiments:
            self._push(self.clock.monotonic() + self.cfg.sweep_interval_s,
                       "housekeep", None)

    # -- main loop --------------------------------------------------------
    def run(self) -> SimReport:
        cfg = self.cfg
        t_wall0 = _wall.perf_counter()
        self._workdir = cfg.workdir or tempfile.mkdtemp(prefix="mtpu-sim-")
        self._own_workdir = cfg.workdir is None
        prev_clock = set_trial_clock(self.clock)
        try:
            self._boot_server()
            workers = self._make_experiments()
            for i, w in enumerate(workers):
                self._push(cfg.spread_s * i / max(1, len(workers)),
                           "cycle", w)
            self._push(cfg.sweep_interval_s, "housekeep", None)
            handlers = {
                "cycle": lambda p: self._ev_cycle(p),
                "complete": lambda p: self._ev_complete(*p),
                "heartbeat": lambda p: self._ev_heartbeat(*p),
                "revive": lambda p: self._ev_revive(p),
                "housekeep": lambda p: self._ev_housekeep(p),
            }
            while self._heap:
                t, _, kind, payload = heapq.heappop(self._heap)
                if t > cfg.max_virtual_s:
                    self._emit("virtual_deadline", at=round(t, 6))
                    break
                self.clock.advance_to(t)
                handlers[kind](payload)
                if len(self._done_exps) >= self.report.experiments:
                    break
            self._finalize()
        finally:
            set_trial_clock(prev_clock)
            if self._own_workdir and self._workdir:
                shutil.rmtree(self._workdir, ignore_errors=True)
        self.report.wall_s = round(_wall.perf_counter() - t_wall0, 3)
        return self.report

    def _finalize(self) -> None:
        srv = self.server
        assert srv is not None
        rep = self.report
        rep.virtual_s = round(self.clock.monotonic(), 6)
        # promotion certification over the REAL hosted algorithm state
        for name, entry in sorted(srv._producers.items()):
            algo = entry[0].algorithm
            quiescent = name in self._done_exps
            rep.promotion_violations.extend(
                promotion_violations(algo, label=name, quiescent=quiescent))
        self._check_acked_writes(after="run")
        # fairness: completions per tenant (equal weights/budgets here)
        xs = [float(v) for v in rep.completed_by_tenant.values()]
        rep.jain = round(jain_index(xs), 6) if xs else 1.0
        # normalize from the recovery with the longest WAL: short-log
        # recoveries are all fixed boot cost, and extrapolating fixed
        # cost to 10k records would swamp the per-record signal
        replayed = [r for r in rep.recoveries if r["wal_records"]]
        if replayed:
            big = max(replayed, key=lambda r: r["wal_records"])
            rep.recovery_s_per_10k_wal = round(
                big["wall_s"] / big["wal_records"] * 10_000, 6)
        self._emit("done", virtual_s=rep.virtual_s,
                   completed=rep.acked_completions,
                   experiments=rep.experiments)
        rep.event_lines = len(self._log)
        blob = "\n".join(self._log) + "\n"
        rep.event_log_sha256 = hashlib.sha256(
            blob.encode("utf-8")).hexdigest()
        if self.cfg.event_log:
            d = os.path.dirname(os.path.abspath(self.cfg.event_log))
            os.makedirs(d, exist_ok=True)
            with open(self.cfg.event_log, "w", encoding="utf-8") as f:
                f.write(blob)
        srv.stop()
        self.server = None
