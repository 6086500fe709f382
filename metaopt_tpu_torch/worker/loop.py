"""workon: the worker main loop.

Port of ``metaopt_tpu/worker/loop.py``:
produce → reserve → consume until the experiment is done; KeyboardInterrupt
marks the in-flight trial interrupted. Kept from the reference: throttled
stale-reservation release (every ``stale_sweep_interval_s``, and always on
the first cycle), per-worker trial caps (``worker_trials``), the
``max_broken`` guard, idle backoff, the judge wiring into the executor, and
infrastructure requeues (``ExecutionResult.requeue``, bounded per trial).
Suspension as in the reference: a reserved trial for which the
algorithm's ``should_suspend`` says so is parked as ``suspended``, never
executed. The batched hunt (``batch_size > 1``, or ``"auto"``) reserves
pools of trials and evaluates each in one ``execute_batch`` call
(:func:`_workon_batched`). ``producer_mode="coord"`` delegates suggestion
to the coordinator's hosted algorithm (:class:`RemoteProducer`) and runs
each trial cycle as one fused ``worker_cycle`` round-trip, with the
previous trial's result push deferred into the next cycle (serial and
batched).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.algo.base import BaseAlgorithm, make_algorithm
from metaopt_tpu_torch.executor.base import Executor
from metaopt_tpu_torch.ledger.experiment import Experiment
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.worker.producer import Producer, RemoteProducer

log = logging.getLogger(__name__)


@dataclass
class WorkerStats:
    reserved: int = 0
    completed: int = 0
    broken: int = 0
    interrupted: int = 0
    pruned: int = 0
    suspended: int = 0
    #: trials bounced back to 'new' after an infrastructure failure
    #: (executor set ExecutionResult.requeue) — retried, not lost
    requeued: int = 0
    idle_cycles: int = 0
    events: List[Dict[str, Any]] = field(default_factory=list)
    #: producer timing aggregates (observe/suggest latency)
    producer_timings: Dict[str, float] = field(default_factory=dict)


def workon(
    experiment: Experiment,
    executor: Executor,
    worker_id: str = "worker-0",
    algorithm: Optional[BaseAlgorithm] = None,
    worker_trials: Optional[int] = None,
    max_broken: Optional[int] = 10,
    heartbeat_timeout_s: float = 60.0,
    idle_sleep_s: float = 0.05,
    max_idle_cycles: int = 200,
    producer_mode: str = "local",
    stop_event: Optional[Any] = None,
    stale_sweep_interval_s: float = 2.0,
    batch_size: Any = 1,
) -> WorkerStats:
    """Run trials until the experiment finishes (or this worker's cap hits).

    ``max_broken`` stops this worker once that many trials have broken — a
    persistently-crashing objective must not spin the produce→break loop
    forever.

    ``producer_mode="coord"`` delegates suggestion (and the judge hook) to
    the coordinator's single hosted algorithm instance instead of fitting a
    local copy — requires the ``coord://`` ledger backend.

    ``stop_event`` (a ``threading.Event``-like): checked between trials —
    how `hunt --n-workers` winds its worker threads down cleanly on Ctrl-C
    (the in-flight trial finishes, the executor closes).

    ``stale_sweep_interval_s``: how often this worker sweeps lapsed
    reservations back to ``new``. A stale reservation is already
    ``heartbeat_timeout_s`` old by definition, so per-cycle sweeping buys
    nothing and costs an RPC/lock round-trip per cycle; the first cycle
    always sweeps (a restart must free its dead predecessor's holds).

    ``batch_size > 1`` switches to the batched hunt: up to that many
    reserved trials evaluate as ONE call into the executor's
    ``execute_batch`` (one pool on a
    :class:`~metaopt_tpu_torch.executor.BatchedExecutor`), with completions
    pushed back in one fused-cycle leg in coord mode. ``"auto"`` sizes the
    batch from the algorithm's population cohort
    (``BaseAlgorithm.cohort_size``) when it has one, else from the
    experiment's pool size (at least 8).
    """
    algo: Optional[BaseAlgorithm]
    if producer_mode == "coord":
        producer: Any = RemoteProducer(experiment, worker=worker_id)
        algo = None
    elif producer_mode == "local":
        algo = algorithm or make_algorithm(experiment.space, experiment.algorithm)
        producer = Producer(experiment, algo)
    else:
        raise ValueError(f"unknown producer_mode {producer_mode!r}")
    if batch_size == "auto":
        # population algorithms emit same-fidelity generations — the natural
        # pool; non-cohort algorithms (or the remote producer, whose algo
        # lives server-side) fall back to the experiment's suggest pool
        cohort = algo.cohort_size if algo is not None else None
        batch_size = cohort or max(int(experiment.pool_size or 1), 8)
    batch_size = int(batch_size)
    if batch_size > 1:
        if not hasattr(executor, "execute_batch"):
            raise ValueError(
                f"batch_size={batch_size} needs an executor with "
                f"execute_batch (got {type(executor).__name__})"
            )
        return _workon_batched(
            experiment, executor, worker_id, producer, algo,
            worker_trials, max_broken, heartbeat_timeout_s, idle_sleep_s,
            max_idle_cycles, stop_event, stale_sweep_interval_s, batch_size,
        )
    stats = WorkerStats()
    # per-trial requeue budget: a wedge-attributed infrastructure failure
    # releases the trial (ExecutionResult.requeue), but only this many
    # times — a permanently dead device must converge to interrupted.
    # The count persists on the trial document (resources), so N workers
    # (or a restarted worker) share ONE budget instead of multiplying it.
    max_requeues = 3
    # first loop iteration always sweeps (resuming after a crash must
    # free the dead predecessor's reservations before producing)
    last_sweep = 0.0
    last_broken_note = ""

    # fused coord path: one worker_cycle RPC per loop iteration replaces
    # the serial release_stale → produce → reserve → count → should_suspend
    # wire sequence (~5 round-trips → 1). The client degrades to the serial
    # composition against a pre-worker_cycle coordinator, so this stays the
    # ONLY coord-mode path either way.
    fused = producer_mode == "coord" and hasattr(
        experiment.ledger, "worker_cycle"
    )
    #: the latest fused-cycle reply — carries the counts/doneness snapshot
    #: the next is_done check reads locally instead of re-RPCing
    last_cycle: Optional[Dict[str, Any]] = None
    #: fused path: a finished trial whose terminal update rides the NEXT
    #: worker_cycle instead of costing its own RPC — (trial, was_pruned);
    #: flushed with a plain update_trial if the loop exits first
    pending_push: Optional[tuple] = None

    def _resolve_push(ok: bool) -> None:
        nonlocal pending_push
        t_done, was_pruned = pending_push  # type: ignore[misc]
        pending_push = None
        if ok:
            stats.completed += 1
            stats.pruned += was_pruned
        else:
            log.warning(
                "%s lost reservation of %s before result push",
                worker_id, t_done.id,
            )

    def _flush_pending() -> None:
        if pending_push is None:
            return
        _resolve_push(experiment.ledger.update_trial(
            pending_push[0], expected_status="reserved",
            expected_worker=worker_id,
        ))

    def heartbeat_for(trial: Trial, primed: bool = False):
        # ``primed``: the fused reply just showed no pending signal for a
        # reservation microseconds old, so the executor's FIRST beat (which
        # it fires immediately on start) is answered locally; every later
        # beat goes to the wire and catches real signals/lost reservations
        state = {"primed": primed}

        def beat() -> bool:
            if state["primed"]:
                state["primed"] = False
                return True
            return experiment.ledger.heartbeat(experiment.name, trial.id, worker_id)
        return beat

    def judge_fn(trial: Trial, partial: List[Dict[str, Any]]):
        return producer.judge(trial, partial)

    def _cycle_done(r: Dict[str, Any]) -> bool:
        """``Experiment.is_done`` evaluated from the fused reply's snapshot
        (doc fields + status counts) instead of 3 fresh RPCs. The snapshot
        is as fresh as serial re-counting w.r.t. THIS worker — _settle()
        folds our own transitions in — and one cycle stale w.r.t. other
        workers, which only costs one extra (budget-guarded) cycle."""
        if r.get("max_trials") is not None:
            # keep the live `db set max_trials=N` override behavior
            experiment.max_trials = r["max_trials"]
        c = r["counts"]
        if c["completed"] >= experiment.max_trials:
            return True
        if not r.get("exp_algo_done"):
            return False
        return c["new"] + c["reserved"] == 0

    def _settle(to_status: str) -> None:
        """Fold this worker's own reserved→terminal transition into the
        cached cycle counts so the next done-check doesn't miss it."""
        if last_cycle is None:
            return
        c = last_cycle["counts"]
        c["reserved"] = max(0, c["reserved"] - 1)
        if to_status in c:
            c[to_status] += 1

    try:
        while True:
            if last_cycle is not None:
                if _cycle_done(last_cycle):
                    break
            elif experiment.is_done:
                break
            if stop_event is not None and stop_event.is_set():
                log.info("%s: stop requested — winding down", worker_id)
                break
            if worker_trials is not None and stats.reserved >= worker_trials:
                log.info("%s: worker_trials cap (%d) reached", worker_id, worker_trials)
                break
            if max_broken is not None and stats.broken >= max_broken:
                log.error(
                    "%s: %d trials broke (max_broken=%d) — is the objective "
                    "runnable? Stopping. Last failure: %s", worker_id,
                    stats.broken, max_broken, last_broken_note or "(no detail)",
                )
                break

            # pacemaker duty, throttled: a stale reservation is minutes old by
            # definition (heartbeat_timeout_s), so sweeping every cycle buys
            # nothing and costs an RPC/lock round-trip per cycle — on the
            # coord backend that was one of ~5 RPCs per trial
            now = time.time()
            sweep = now - last_sweep >= stale_sweep_interval_s
            if fused:
                # skip the produce leg when the registration budget is provably
                # exhausted: completed+new+reserved only grows (requeues move
                # within the sum), so a one-cycle-stale sum >= max_trials still
                # proves no suggest can register — the produce would be a pure
                # no-op observe. Only when the server says the algorithm is
                # passive (``algo_passive``: no judge/suspend verdicts consult
                # the fit between produces), so observe timing is unobservable
                # and the suggestion stream provably identical. Trials leaving
                # the sum (broken/interrupted) reopen budget; the next reply's
                # fresh counts catch that one cycle later.
                produce_cycle = True
                if (last_cycle is not None
                        and last_cycle.get("algo_passive")
                        and experiment.max_trials is not None):
                    c = last_cycle["counts"]
                    produce_cycle = (
                        c["new"] + c["reserved"] + c["completed"]
                        < experiment.max_trials
                    )
                complete = None
                if pending_push is not None:
                    complete = {
                        "trial": pending_push[0].to_dict(),
                        "expected_status": "reserved",
                        "expected_worker": worker_id,
                    }
                last_cycle = producer.cycle(
                    stale_timeout_s=heartbeat_timeout_s if sweep else None,
                    produce=produce_cycle,
                    complete=complete,
                )
                if complete is not None:
                    _resolve_push(bool(last_cycle.get("completed_ok")))
                produced = last_cycle["registered"]
                trial = last_cycle["trial"]
            else:
                if sweep:
                    experiment.ledger.release_stale(
                        experiment.name, heartbeat_timeout_s
                    )
                produced = producer.produce()
                trial = experiment.reserve_trial(worker_id)
            if sweep:
                last_sweep = now

            if trial is None:
                # nothing to run: either in-flight trials elsewhere, an algorithm
                # barrier (sync rungs / generation waits), or true exhaustion
                in_flight = (
                    last_cycle["counts"]["reserved"]
                    if last_cycle is not None
                    else experiment.count("reserved")
                )
                if produced == 0 and in_flight == 0:
                    stats.idle_cycles += 1
                    if producer.algo_done or stats.idle_cycles > max_idle_cycles:
                        log.info("%s: no work producible; stopping", worker_id)
                        break
                else:
                    stats.idle_cycles = 0
                time.sleep(idle_sleep_s)
                continue

            stats.idle_cycles = 0
            stats.reserved += 1
            suspend = (
                last_cycle["suspend"]  # verdict rode the fused reply
                if last_cycle is not None
                else producer.should_suspend(trial)
            )
            if suspend:
                # the algorithm wants this trial parked (e.g. a bracket wants
                # its budget elsewhere first): suspended, not executed;
                # ``resume`` flips suspended trials back to new
                trial.transition("suspended")
                experiment.ledger.update_trial(
                    trial, expected_status="reserved", expected_worker=worker_id
                )
                stats.suspended += 1
                _settle("suspended")
                continue
            log.debug("%s running trial %s %s", worker_id, trial.id[:8], trial.params)
            t0 = time.time()
            try:
                res = executor.execute(
                    trial,
                    heartbeat=heartbeat_for(
                        trial,
                        # safe to answer the executor's immediate first beat
                        # locally: the fused reply just told us this fresh
                        # reservation has no pending signal
                        primed=(last_cycle is not None
                                and last_cycle.get("fused", False)
                                and last_cycle.get("signal") is None),
                    ),
                    judge=judge_fn,
                )
            except KeyboardInterrupt:
                trial.transition("interrupted")
                experiment.ledger.update_trial(
                    trial, expected_status="reserved", expected_worker=worker_id
                )
                stats.interrupted += 1
                raise

            trial.exit_code = res.exit_code
            if res.status == "completed":
                if fused:
                    # defer the terminal update: it rides the next worker_cycle
                    # (the cycle is due immediately anyway), so the steady-state
                    # coord cost is ~1 RPC per trial instead of 2. The server
                    # applies it before its produce/reserve legs — same order
                    # as push-then-cycle — and the reply's counts/doneness
                    # already include it, so no _settle here.
                    trial.attach_results(res.results)
                    trial.transition("completed")
                    pending_push = (trial, int("pruned" in res.note))
                else:
                    ok = experiment.push_results(trial, res.results)
                    if ok:
                        stats.completed += 1
                        _settle("completed")
                        if "pruned" in res.note:
                            stats.pruned += 1
                    else:
                        log.warning(
                            "%s lost reservation of %s before result push",
                            worker_id, trial.id,
                        )
            elif (res.requeue
                  and int(trial.resources.get("requeues", 0)) < max_requeues):
                # infrastructure failure (device wedge/park budget): release
                # the trial back to 'new' so this or another worker retries it
                # once the device recovers; bounded per trial so a permanently
                # dead backend still converges to interrupted
                n_req = int(trial.resources.get("requeues", 0)) + 1
                trial.reset_to_new()
                # AFTER reset_to_new, which clears resources — the counter
                # must survive into the ledger or the budget never binds
                trial.resources["requeues"] = n_req
                ok = experiment.ledger.update_trial(
                    trial, expected_status="reserved", expected_worker=worker_id
                )
                if ok:
                    stats.requeued += 1
                    _settle("new")
                    log.warning(
                        "%s requeued trial %s (%d/%d): %s", worker_id,
                        trial.id[:8], n_req, max_requeues, res.note,
                    )
                else:
                    log.warning(
                        "%s lost reservation of %s before requeue write-back",
                        worker_id, trial.id,
                    )
            else:
                if res.requeue:
                    # the executor flagged a retry, but the shared budget is
                    # spent — the stored outcome must say what actually
                    # happens (nothing, until a human resumes it)
                    res.note += " (requeue budget exhausted — see `resume`)"
                trial.transition(res.status)
                experiment.ledger.update_trial(
                    trial, expected_status="reserved", expected_worker=worker_id
                )
                _settle(res.status)
                stats.broken += res.status == "broken"
                stats.interrupted += res.status == "interrupted"
                if res.status == "broken":
                    # the note carries the evidence (exit code + stderr tail);
                    # at INFO it is invisible under the default CLI level and
                    # the eventual max_broken ERROR reads as evidence-free
                    last_broken_note = res.note
                    if res.note:
                        log.warning(
                            "%s: trial %s broken: %s",
                            worker_id, trial.id[:8], res.note)
                elif res.note:
                    log.info("trial %s %s: %s", trial.id[:8], res.status, res.note)
            stats.events.append(
                {
                    "trial": trial.id,
                    "status": res.status,
                    "runtime_s": round(time.time() - t0, 4),
                    "note": res.note,
                }
            )
    except BaseException:
        # error exits (coordinator unavailable, executor blow-ups, the
        # KeyboardInterrupt re-raise) still attempt the deferred push,
        # best-effort: the flush must not mask the original failure
        try:
            _flush_pending()
        except Exception:
            log.warning(
                "%s: deferred result push failed during error unwind "
                "(the stale sweep will re-free the trial)", worker_id,
            )
        raise
    # a result the next cycle never got to carry (the loop exited first)
    # still must reach the ledger — the deferred push is an optimization,
    # never a correctness trade
    _flush_pending()
    # final observe so the algorithm state is current for callers (the
    # coordinator-hosted algorithm observes inside its own produce cycles)
    if algo is not None:
        algo.observe(experiment.fetch_completed_trials())
    stats.producer_timings = dict(producer.timings)
    return stats


def _workon_batched(
    experiment: Experiment,
    executor: Executor,
    worker_id: str,
    producer: Any,
    algo: Optional[BaseAlgorithm],
    worker_trials: Optional[int],
    max_broken: Optional[int],
    heartbeat_timeout_s: float,
    idle_sleep_s: float,
    max_idle_cycles: int,
    stop_event: Optional[Any],
    stale_sweep_interval_s: float,
    batch_size: int,
) -> WorkerStats:
    """The batched hunt: pools of trials through ``executor.execute_batch``.

    Each outer iteration reserves up to ``batch_size`` trials — on the
    coord backend through repeated fused ``worker_cycle`` calls (the first
    carries the produce leg and the previous pool's multi-trial result
    push; the rest are reserve-only) — and evaluates them in ONE executor
    call, so a population generation or ASHA rung cohort is a single
    device program. Status handling per trial mirrors the serial loop;
    completions ride the next cycle's ``complete.trials`` leg so the
    steady-state coord cost stays ~1 RPC per trial.
    """
    stats = WorkerStats()
    fused = isinstance(producer, RemoteProducer) and hasattr(
        experiment.ledger, "worker_cycle"
    )
    last_cycle: Optional[Dict[str, Any]] = None
    last_sweep = 0.0
    last_broken_note = ""
    #: completed trials awaiting the next cycle's multi-trial complete
    #: leg — (trial, was_pruned), flushed directly if the loop exits first
    pending: List[tuple] = []

    def _resolve(flushed: List[tuple], oks: List[bool]) -> None:
        for (t_done, was_pruned), ok in zip(flushed, oks):
            if ok:
                stats.completed += 1
                stats.pruned += was_pruned
            else:
                log.warning(
                    "%s lost reservation of %s before result push",
                    worker_id, t_done.id,
                )

    def _flush_pending() -> None:
        nonlocal pending
        flushed, pending = pending, []
        if flushed:
            _resolve(flushed, [
                experiment.ledger.update_trial(
                    t, expected_status="reserved", expected_worker=worker_id
                )
                for t, _ in flushed
            ])

    def _cycle_done(r: Dict[str, Any]) -> bool:
        # same snapshot evaluation as the serial loop; our own pool's
        # completions are at most one cycle behind (they ride the next
        # cycle's push leg, whose reply refreshes these counts)
        if r.get("max_trials") is not None:
            experiment.max_trials = r["max_trials"]
        c = r["counts"]
        if c["completed"] >= experiment.max_trials:
            return True
        if not r.get("exp_algo_done"):
            return False
        return c["new"] + c["reserved"] == 0

    def heartbeat_for(trial: Trial, primed: bool = False):
        state = {"primed": primed}

        def beat() -> bool:
            if state["primed"]:
                state["primed"] = False
                return True
            return experiment.ledger.heartbeat(
                experiment.name, trial.id, worker_id
            )
        return beat

    def _park_suspended(trial: Trial) -> None:
        trial.transition("suspended")
        experiment.ledger.update_trial(
            trial, expected_status="reserved", expected_worker=worker_id
        )
        stats.suspended += 1

    try:
        while True:
            if last_cycle is not None:
                if _cycle_done(last_cycle):
                    break
            elif experiment.is_done:
                break
            if stop_event is not None and stop_event.is_set():
                log.info("%s: stop requested — winding down", worker_id)
                break
            if worker_trials is not None and stats.reserved >= worker_trials:
                log.info(
                    "%s: worker_trials cap (%d) reached", worker_id,
                    worker_trials,
                )
                break
            if max_broken is not None and stats.broken >= max_broken:
                log.error(
                    "%s: %d trials broke (max_broken=%d) — is the objective "
                    "runnable? Stopping. Last failure: %s", worker_id,
                    stats.broken, max_broken, last_broken_note or "(no detail)",
                )
                break

            want = batch_size
            if worker_trials is not None:
                want = min(want, worker_trials - stats.reserved)
            now = time.time()
            sweep = now - last_sweep >= stale_sweep_interval_s
            batch: List[Trial] = []
            primed: List[bool] = []
            produced = 0
            if fused:
                first = True
                while len(batch) < want:
                    complete = None
                    if first and pending:
                        complete = {
                            "trials": [t.to_dict() for t, _ in pending],
                            "expected_status": "reserved",
                            "expected_worker": worker_id,
                        }
                    r = producer.cycle(
                        pool_size=want,
                        stale_timeout_s=(
                            heartbeat_timeout_s if sweep and first else None
                        ),
                        produce=first,
                        complete=complete,
                    )
                    last_cycle = r
                    if complete is not None:
                        flushed, pending = pending, []
                        oks = r.get("completed_oks")
                        if oks is None:
                            # push leg didn't apply (degraded reply): the
                            # trials are still reserved — flush directly
                            oks = [
                                experiment.ledger.update_trial(
                                    t, expected_status="reserved",
                                    expected_worker=worker_id,
                                )
                                for t, _ in flushed
                            ]
                        _resolve(flushed, oks)
                    if first:
                        produced = r["registered"]
                    first = False
                    t = r["trial"]
                    if t is None:
                        break
                    if r["suspend"]:
                        _park_suspended(t)
                        continue
                    batch.append(t)
                    primed.append(
                        bool(r.get("fused")) and r.get("signal") is None
                    )
            else:
                if sweep:
                    experiment.ledger.release_stale(
                        experiment.name, heartbeat_timeout_s
                    )
                produced = producer.produce(pool_size=want)
                while len(batch) < want:
                    t = experiment.reserve_trial(worker_id)
                    if t is None:
                        break
                    if producer.should_suspend(t):
                        _park_suspended(t)
                        continue
                    batch.append(t)
                    primed.append(False)
            if sweep:
                last_sweep = now

            if not batch:
                in_flight = (
                    last_cycle["counts"]["reserved"]
                    if last_cycle is not None
                    else experiment.count("reserved")
                )
                if produced == 0 and in_flight == 0:
                    stats.idle_cycles += 1
                    if producer.algo_done or stats.idle_cycles > max_idle_cycles:
                        log.info("%s: no work producible; stopping", worker_id)
                        break
                else:
                    stats.idle_cycles = 0
                time.sleep(idle_sleep_s)
                continue

            stats.idle_cycles = 0
            stats.reserved += len(batch)
            log.debug(
                "%s running pool of %d trials", worker_id, len(batch)
            )
            t0 = time.time()
            try:
                results = executor.execute_batch(
                    batch,
                    heartbeats=[
                        heartbeat_for(t, primed=p)
                        for t, p in zip(batch, primed)
                    ],
                )
            except KeyboardInterrupt:
                for t in batch:
                    t.transition("interrupted")
                    experiment.ledger.update_trial(
                        t, expected_status="reserved",
                        expected_worker=worker_id,
                    )
                    stats.interrupted += 1
                raise
            runtime_s = round(time.time() - t0, 4)

            for trial, res in zip(batch, results):
                trial.exit_code = res.exit_code
                if res.status == "completed":
                    if fused:
                        trial.attach_results(res.results)
                        trial.transition("completed")
                        pending.append((trial, int("pruned" in res.note)))
                    else:
                        if experiment.push_results(trial, res.results):
                            stats.completed += 1
                            stats.pruned += int("pruned" in res.note)
                        else:
                            log.warning(
                                "%s lost reservation of %s before result "
                                "push", worker_id, trial.id,
                            )
                else:
                    # broken / interrupted (the batched executor never
                    # requeues: a pool-level infrastructure failure surfaces
                    # as broken notes, the worker guard handles persistence)
                    trial.transition(res.status)
                    experiment.ledger.update_trial(
                        trial, expected_status="reserved",
                        expected_worker=worker_id,
                    )
                    stats.broken += res.status == "broken"
                    stats.interrupted += res.status == "interrupted"
                    if res.status == "broken":
                        last_broken_note = res.note
                        if res.note:
                            log.warning(
                                "%s: trial %s broken: %s",
                                worker_id, trial.id[:8], res.note,
                            )
                stats.events.append({
                    "trial": trial.id,
                    "status": res.status,
                    "runtime_s": runtime_s,
                    "note": res.note,
                    "pool": len(batch),
                })
    except BaseException:
        try:
            _flush_pending()
        except Exception:
            log.warning(
                "%s: deferred pool push failed during error unwind "
                "(the stale sweep will re-free the trials)", worker_id,
            )
        raise
    _flush_pending()
    if algo is not None:
        algo.observe(experiment.fetch_completed_trials())
    stats.producer_timings = dict(producer.timings)
    return stats
