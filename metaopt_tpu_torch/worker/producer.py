"""Producer: the algorithm-facing pump.

Port of ``metaopt_tpu/worker/producer.py``, trimmed to the local
:class:`Producer` cycle: fetch completed trials → ``algo.observe()`` →
``algo.set_pending(reserved)`` for parallel-strategy algorithms →
``algo.suggest(pool_size)`` → register (the ledger's duplicate detection
absorbs suggestion races between workers). The reference's warm start,
transfer priors and EVC branch adaptation, and the coordinator-hosted
``RemoteProducer``, are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from metaopt_tpu_torch.algo.base import BaseAlgorithm
from metaopt_tpu_torch.ledger.experiment import Experiment

log = logging.getLogger(__name__)


class Producer:
    def __init__(self, experiment: Experiment, algorithm: BaseAlgorithm):
        self.experiment = experiment
        self.algorithm = algorithm
        #: rolling timing aggregates (suggest-latency events)
        self.timings: Dict[str, float] = {
            "observe_s": 0.0, "suggest_s": 0.0, "cycles": 0, "suggested": 0,
        }
        self.algo_done = False
        #: incremental-observe cursor (fetch_completed_since)
        self._completed_cursor = None

    def produce(self, pool_size: Optional[int] = None) -> int:
        """One observe→suggest→register cycle; returns #trials registered."""
        exp = self.experiment
        t0 = time.perf_counter()
        # incremental observe: only the trials completed since the last
        # cycle; the cursor is committed only after observe succeeded
        new_done, next_cursor = exp.fetch_completed_since(
            self._completed_cursor
        )
        self.algorithm.observe(new_done)
        self._completed_cursor = next_cursor
        if self.algorithm.supports_pending:
            # parallel strategy (lineage "liar"): in-flight trials join
            # the fit with a lie objective so N racing workers don't pile
            # suggestions onto points already being evaluated
            self.algorithm.set_pending(exp.fetch_trials("reserved"))
        self.timings["observe_s"] += time.perf_counter() - t0
        self.timings["cycles"] += 1

        if self.algorithm.is_done:
            self.algo_done = True
            exp.mark_algo_done()
            return 0

        # don't flood the ledger past max_trials with pending work
        pending = exp.count(("new", "reserved"))
        completed = exp.count("completed")
        budget_left = exp.max_trials - completed - pending
        want = min(pool_size or exp.pool_size, max(0, budget_left))
        if want <= 0:
            return 0

        t1 = time.perf_counter()
        points = self.algorithm.suggest(want)
        self.timings["suggest_s"] += time.perf_counter() - t1
        self.timings["suggested"] += len(points)
        if not points:
            return 0
        trials = [
            exp.make_trial(
                {k: v for k, v in p.items() if k != "_parent"},
                parent=p.get("_parent"),
            )
            for p in points
        ]
        kept = exp.register_trials(trials)
        if len(kept) < len(trials):
            log.debug(
                "producer: %d/%d suggestions were duplicates",
                len(trials) - len(kept), len(trials),
            )
        return len(kept)

    def judge(self, trial, partial):
        return self.algorithm.judge(trial, partial)
