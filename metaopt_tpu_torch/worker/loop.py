"""workon: the worker main loop.

Port of ``metaopt_tpu/worker/loop.py``, trimmed to the local-producer loop:
produce → reserve → consume until the experiment is done; KeyboardInterrupt
marks the in-flight trial interrupted. Kept from the reference: throttled
stale-reservation release (every ``stale_sweep_interval_s``, and always on
the first cycle), per-worker trial caps (``worker_trials``), the
``max_broken`` guard, idle backoff, the judge wiring into the executor, and
infrastructure requeues (``ExecutionResult.requeue``, bounded per trial).
Not ported yet: the coordinator-hosted producer and its fused cycle, the
batched hunt (``batch_size > 1``) and suspension.
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
    """
    if producer_mode != "local":
        raise NotImplementedError(f"producer {producer_mode!r}: coordinator producer "
                                  "not ported yet")
    algo = algorithm or make_algorithm(experiment.space, experiment.algorithm)
    producer = Producer(experiment, algo)
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
