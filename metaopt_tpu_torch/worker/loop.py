"""workon: the worker main loop.

Port of ``metaopt_tpu/worker/loop.py``, trimmed to the local-producer loop:
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
(:func:`_workon_batched`). Not ported yet: the coordinator-hosted producer
and its fused cycle (serial and batched).
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
from metaopt_tpu_torch.worker.producer import Producer

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
    forever. ``stop_event`` (a ``threading.Event``-like) is checked between
    trials. ``stale_sweep_interval_s``: how often this worker sweeps lapsed
    reservations back to ``new``; the first cycle always sweeps.
    ``producer_mode`` must be ``"local"`` (the algorithm fits in this
    worker); the reference's coordinator-hosted ``"coord"`` producer is not
    ported yet.

    ``batch_size > 1`` switches to the batched hunt: up to that many
    reserved trials evaluate as ONE call into the executor's
    ``execute_batch`` (one pool on a
    :class:`~metaopt_tpu_torch.executor.BatchedExecutor`). ``"auto"`` sizes
    the batch from the algorithm's population cohort
    (``BaseAlgorithm.cohort_size``) when it has one, else from the
    experiment's pool size (at least 8).
    """
    if producer_mode != "local":
        raise NotImplementedError(f"producer {producer_mode!r}: coordinator producer "
                                  "not ported yet")
    algo = algorithm or make_algorithm(experiment.space, experiment.algorithm)
    producer = Producer(experiment, algo)
    if batch_size == "auto":
        # population algorithms emit same-fidelity generations — the natural
        # pool; non-cohort algorithms fall back to the experiment's pool
        batch_size = algo.cohort_size or max(int(experiment.pool_size or 1), 8)
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
    last_sweep = 0.0
    last_broken_note = ""

    def heartbeat_for(trial: Trial):
        def beat() -> bool:
            return experiment.ledger.heartbeat(experiment.name, trial.id, worker_id)
        return beat

    def judge_fn(trial: Trial, partial: List[Dict[str, Any]]):
        return producer.judge(trial, partial)

    while True:
        if experiment.is_done:
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

        now = time.time()
        if now - last_sweep >= stale_sweep_interval_s:
            experiment.ledger.release_stale(experiment.name, heartbeat_timeout_s)
            last_sweep = now
        produced = producer.produce()
        trial = experiment.reserve_trial(worker_id)

        if trial is None:
            # nothing to run: in-flight trials elsewhere, an algorithm
            # barrier, or true exhaustion
            if produced == 0 and experiment.count("reserved") == 0:
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
        if producer.should_suspend(trial):
            # the algorithm wants this trial parked (e.g. a bracket wants
            # its budget elsewhere first): suspended, not executed;
            # ``resume`` flips suspended trials back to new
            trial.transition("suspended")
            experiment.ledger.update_trial(
                trial, expected_status="reserved", expected_worker=worker_id
            )
            stats.suspended += 1
            continue
        log.debug("%s running trial %s %s", worker_id, trial.id[:8], trial.params)
        t0 = time.time()
        try:
            res = executor.execute(trial, heartbeat=heartbeat_for(trial),
                                   judge=judge_fn)
        except KeyboardInterrupt:
            trial.transition("interrupted")
            experiment.ledger.update_trial(
                trial, expected_status="reserved", expected_worker=worker_id
            )
            stats.interrupted += 1
            raise

        trial.exit_code = res.exit_code
        if res.status == "completed":
            if experiment.push_results(trial, res.results):
                stats.completed += 1
                if "pruned" in res.note:
                    stats.pruned += 1
            else:
                log.warning(
                    "%s lost reservation of %s before result push",
                    worker_id, trial.id,
                )
        elif (res.requeue
              and int(trial.resources.get("requeues", 0)) < max_requeues):
            # infrastructure failure (device wedge/park budget): release the
            # trial back to 'new' so this or another worker retries it once
            # the device recovers; bounded per trial so a permanently dead
            # device still converges to interrupted
            n_req = int(trial.resources.get("requeues", 0)) + 1
            trial.reset_to_new()
            # AFTER reset_to_new, which clears resources — the counter must
            # survive into the ledger or the budget never binds
            trial.resources["requeues"] = n_req
            if experiment.ledger.update_trial(
                trial, expected_status="reserved", expected_worker=worker_id
            ):
                stats.requeued += 1
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
                # spent — the stored outcome must say what actually happens
                # (nothing, until a human resumes it)
                res.note += " (requeue budget exhausted — see `resume`)"
            trial.transition(res.status)
            experiment.ledger.update_trial(
                trial, expected_status="reserved", expected_worker=worker_id
            )
            stats.broken += res.status == "broken"
            stats.interrupted += res.status == "interrupted"
            if res.status == "broken":
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

    # final observe so the algorithm state is current for callers
    algo.observe(experiment.fetch_completed_trials())
    stats.producer_timings = dict(producer.timings)
    return stats


def _workon_batched(
    experiment: Experiment,
    executor: Executor,
    worker_id: str,
    producer: Producer,
    algo: BaseAlgorithm,
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

    Each outer iteration produces, then reserves up to ``batch_size``
    trials (parking those the algorithm wants suspended) and evaluates them
    in ONE executor call, so a population generation or ASHA rung cohort
    is a single pool on the device. Status handling per trial mirrors the
    serial loop; the batched executor never requeues (a pool-level failure
    surfaces as broken notes, and the ``max_broken`` guard handles
    persistence).
    """
    stats = WorkerStats()
    last_sweep = 0.0
    last_broken_note = ""

    def heartbeat_for(trial: Trial):
        def beat() -> bool:
            return experiment.ledger.heartbeat(experiment.name, trial.id, worker_id)
        return beat

    def _park_suspended(trial: Trial) -> None:
        trial.transition("suspended")
        experiment.ledger.update_trial(
            trial, expected_status="reserved", expected_worker=worker_id
        )
        stats.suspended += 1

    while True:
        if experiment.is_done:
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

        want = batch_size
        if worker_trials is not None:
            want = min(want, worker_trials - stats.reserved)
        now = time.time()
        if now - last_sweep >= stale_sweep_interval_s:
            experiment.ledger.release_stale(experiment.name, heartbeat_timeout_s)
            last_sweep = now
        produced = producer.produce(pool_size=want)
        batch: List[Trial] = []
        while len(batch) < want:
            t = experiment.reserve_trial(worker_id)
            if t is None:
                break
            if producer.should_suspend(t):
                _park_suspended(t)
                continue
            batch.append(t)

        if not batch:
            if produced == 0 and experiment.count("reserved") == 0:
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
        log.debug("%s running pool of %d trials", worker_id, len(batch))
        t0 = time.time()
        try:
            results = executor.execute_batch(
                batch, heartbeats=[heartbeat_for(t) for t in batch])
        except KeyboardInterrupt:
            for t in batch:
                t.transition("interrupted")
                experiment.ledger.update_trial(
                    t, expected_status="reserved", expected_worker=worker_id
                )
                stats.interrupted += 1
            raise
        runtime_s = round(time.time() - t0, 4)

        for trial, res in zip(batch, results):
            trial.exit_code = res.exit_code
            if res.status == "completed":
                if experiment.push_results(trial, res.results):
                    stats.completed += 1
                    stats.pruned += int("pruned" in res.note)
                else:
                    log.warning(
                        "%s lost reservation of %s before result push",
                        worker_id, trial.id,
                    )
            else:
                trial.transition(res.status)
                experiment.ledger.update_trial(
                    trial, expected_status="reserved", expected_worker=worker_id
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

    algo.observe(experiment.fetch_completed_trials())
    stats.producer_timings = dict(producer.timings)
    return stats
