"""Producer: the algorithm-facing pump.

Port of ``metaopt_tpu/worker/producer.py``. The local
:class:`Producer` cycle: warm start once (transfer priors from
``metadata.transfer_from`` through ``observe_prior``, then the EVC branch
parent through the :class:`~metaopt_tpu_torch.ledger.evc.TrialAdapter`,
then ``metadata.warm_start`` through the in-space filter) → fetch
completed trials → ``algo.observe()`` → ``algo.set_pending(reserved)`` for
parallel-strategy algorithms → ``algo.suggest(pool_size)`` → register (the
ledger's duplicate detection absorbs suggestion races between workers).
:class:`RemoteProducer` is the coordinator-hosted facade: the cycle runs
on the coordinator's single algorithm instance (``coord://`` ledgers).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

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
        self._warm_started = False
        #: seconds the one-time warm start took (transfer priors, branch
        #: parent, warm-start source), also inside ``timings["observe_s"]``
        self.warm_start_s = 0.0
        #: incremental-observe cursor (fetch_completed_since)
        self._completed_cursor = None

    def produce(self, pool_size: Optional[int] = None) -> int:
        """One observe→suggest→register cycle; returns #trials registered."""
        exp = self.experiment
        t0 = time.perf_counter()
        if not self._warm_started:
            # warm start (lineage EVC role): replay another experiment's
            # completions into the algorithm once, before first suggest —
            # the surrogate starts informed, trial identity stays local
            self._warm_started = True
            meta = exp.metadata or {}
            # transfer priors seed FIRST: they must occupy the oldest
            # observation rows so the algorithm's n_prior discount (TPE
            # weights / GP subsample) addresses exactly them
            transfer = meta.get("transfer_from")
            if transfer:
                self._seed_transfer_priors(transfer, meta)
            branch = meta.get("branch")
            # both can be set at once: the branch parent replays through the
            # space adapter, an additional warm-start source through the
            # plain in-space filter — neither may shadow the other
            sources = []
            if branch and branch.get("parent") and branch["parent"] != exp.name:
                sources.append((branch["parent"], branch))
            warm = meta.get("warm_start")
            if warm and warm != exp.name and warm != (branch or {}).get("parent"):
                sources.append((warm, None))
            for src, src_branch in sources:
                fetched = exp.ledger.fetch(src, "completed")
                usable = self._adapt_foreign(fetched, src, src_branch)
                if usable:
                    self.algorithm.observe(usable)
                log.info(
                    "warm start: observed %d/%d completed trials from %r",
                    len(usable), len(fetched), src,
                )
            self.warm_start_s = time.perf_counter() - t0
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

    def _seed_transfer_priors(self, transfer, meta) -> None:
        """Seed the algorithm from EVC-admissible ancestors.

        ``metadata.transfer_from`` names ancestor experiments directly
        (a string or list of names), or the sentinel ``"evc"`` which
        resolves the branch-parent chain via
        :func:`metaopt_tpu_torch.ledger.evc.branch_parent`. Each ancestor's
        completed trials are space-remapped through the same
        :class:`TrialAdapter` path as branch warm-start (an inadmissible
        ancestor degrades to the in-space filter, never poisons the fit)
        and fed to ``observe_prior`` — tagged prior rows the acquisition
        discounts against locally-measured evidence.
        """
        exp = self.experiment
        items = [transfer] if isinstance(transfer, str) else list(transfer)
        names = []
        for item in items:
            if item == "evc":
                from metaopt_tpu_torch.ledger.evc import branch_parent

                seen = {exp.name}
                parent = branch_parent(
                    {"name": exp.name, "metadata": meta})
                while parent and parent not in seen and len(names) < 8:
                    names.append(parent)
                    seen.add(parent)
                    doc = exp.ledger.load_experiment(parent)
                    parent = branch_parent(doc) if doc else None
            elif item != exp.name and item not in names:
                names.append(item)
        for src in names:
            try:
                fetched = exp.ledger.fetch(src, "completed")
            except Exception as err:
                log.warning("transfer ancestor %r unreadable: %s", src, err)
                continue
            usable = self._adapt_foreign(
                fetched, src, {"defaults": None, "renames": None})
            usable = [t for t in usable if t.objective is not None]
            if usable:
                self.algorithm.observe_prior(usable)
            log.info(
                "transfer priors: seeded %d/%d completed trials from %r",
                len(usable), len(fetched), src,
            )

    def _adapt_foreign(self, fetched, src, branch):
        """Fit another experiment's trials to this space (EVC branch path)."""
        exp = self.experiment
        if branch and exp.space is not None:
            from metaopt_tpu_torch.ledger.evc import BranchConflictError, TrialAdapter
            from metaopt_tpu_torch.space import build_space

            parent_doc = exp.ledger.load_experiment(src)
            if parent_doc is not None:
                try:
                    adapter = TrialAdapter(
                        build_space(parent_doc["space"]),
                        exp.space,
                        branch.get("defaults"),
                        branch.get("renames"),
                    )
                    return [a for a in map(adapter.adapt, fetched) if a]
                except BranchConflictError as err:
                    log.warning("branch adapter rejected: %s; filtering", err)
        return [t for t in fetched
                if exp.space is None or t.params in exp.space]

    def judge(self, trial, partial):
        return self.algorithm.judge(trial, partial)

    def should_suspend(self, trial) -> bool:
        return self.algorithm.should_suspend(trial)


class RemoteProducer:
    """Producer facade that delegates the cycle to the coordinator.

    The coordinator owns ONE algorithm instance per experiment, on its
    device (see
    ``CoordServer._hosted_producer``); workers just ask it to produce and
    then reserve as usual. N workers therefore share one fitted surrogate —
    no redundant per-worker re-fits, no divergent suggestion streams — while
    the decentralized :class:`Producer` remains the fallback for ledger
    backends with no coordinator (memory/file/native).

    Concurrent produce RPCs from different workers may be COALESCED by the
    server into one combined cycle (one fused suggest launch serves every
    request in the window). The reply's ``registered`` is then the combined
    cycle's total — correct for this facade's only consumer, the workon
    loop, which reads it purely as a progress/idle signal; the
    ``coalesced`` reply field is surfaced in ``timings["coalesced"]`` (how
    many of this worker's cycles shared a launch with at least one other
    request).
    """

    def __init__(self, experiment: Experiment, worker: Optional[str] = None):
        ledger = experiment.ledger
        if not hasattr(ledger, "produce"):
            raise ValueError(
                "coordinator-hosted suggestion needs the coord:// ledger "
                f"backend (got {type(ledger).__name__})"
            )
        self.experiment = experiment
        self.worker = worker
        self.timings: Dict[str, float] = {
            "produce_rpc_s": 0.0, "cycles": 0, "suggested": 0, "remote": 1,
            "coalesced": 0,
        }
        self.algo_done = False

    def produce(self, pool_size: Optional[int] = None) -> int:
        t0 = time.perf_counter()
        out = self.experiment.ledger.produce(
            self.experiment.name,
            pool_size or self.experiment.pool_size,
            worker=self.worker,
        )
        self.timings["produce_rpc_s"] += time.perf_counter() - t0
        self.timings["cycles"] += 1
        self.timings["suggested"] += out["registered"]
        if int(out.get("coalesced", 1)) > 1:
            self.timings["coalesced"] += 1
        self.algo_done = bool(out.get("algo_done"))
        return out["registered"]

    def cycle(
        self,
        pool_size: Optional[int] = None,
        stale_timeout_s: Optional[float] = None,
        produce: bool = True,
        complete: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """One fused worker cycle (push→sweep→produce→reserve→counts) in a
        single round-trip — see ``CoordLedgerClient.worker_cycle``. The
        produce leg rides the server's shared coalescer, so the registered
        suggestion stream is bit-identical to :meth:`produce` + reserve
        served serially; against a pre-``worker_cycle`` coordinator the
        client composes the same reply from the serial RPCs.

        ``produce=False`` skips the produce leg (the workon loop sends it
        when the registration budget is provably exhausted — a no-op cycle
        not worth a fit-lock round-trip); ``complete`` carries the
        previous trial's deferred terminal update."""
        t0 = time.perf_counter()
        out = self.experiment.ledger.worker_cycle(
            self.experiment.name,
            self.worker or "worker",
            pool_size=pool_size or self.experiment.pool_size,
            stale_timeout_s=stale_timeout_s,
            produce=produce,
            complete=complete,
        )
        self.timings["produce_rpc_s"] += time.perf_counter() - t0
        self.timings["cycles"] += 1
        self.timings["suggested"] += out["registered"]
        if int(out.get("coalesced", 1)) > 1:
            self.timings["coalesced"] += 1
        if out.get("fused"):
            self.timings["fused_cycles"] = (
                self.timings.get("fused_cycles", 0) + 1
            )
        if produce:
            self.algo_done = bool(out.get("algo_done"))
        return out

    def judge(self, trial, partial):
        return self.experiment.ledger.judge(self.experiment.name, trial, partial)

    def should_suspend(self, trial) -> bool:
        return bool(self.experiment.ledger.should_suspend(
            self.experiment.name, trial
        ))
