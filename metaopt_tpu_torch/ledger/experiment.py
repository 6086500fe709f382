"""Experiment: the named search — space + algorithm config + trial collection.

ref: src/metaopt/core/worker/experiment.py — create-or-load by name with
config adoption/branching, trial registration/reservation/fetching, and
``is_done`` when completed ≥ max_trials or the algorithm declares completion
(SURVEY.md §2.1). The DB round-trips become ledger-backend calls; identity
races (two workers creating the same experiment) resolve exactly like the
reference: the loser of the create race silently adopts the winner's config.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.io.resolve_config import fetch_metadata
from metaopt_tpu_torch.ledger.backends import (
    DuplicateExperimentError,
    DuplicateTrialError,
    LedgerBackend,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space, build_space

log = logging.getLogger(__name__)


class Experiment:
    """DB^W ledger-backed experiment document + trial operations."""

    def __init__(
        self,
        name: str,
        ledger: LedgerBackend,
        space: Optional[Space] = None,
        algorithm: Optional[Dict[str, Any]] = None,
        max_trials: int = 100,
        pool_size: int = 1,
        metadata: Optional[Dict[str, Any]] = None,
        user_args: Optional[List[str]] = None,
        version: int = 1,
    ) -> None:
        self.name = name
        self.ledger = ledger
        self.space = space
        self.algorithm = algorithm or {"random": {}}
        self.max_trials = max_trials
        self.pool_size = pool_size
        self.metadata = metadata or {}
        self.user_args = list(user_args or [])
        self.version = version
        self._configured = False

    # -- configure: create-or-load ---------------------------------------
    def configure(self) -> "Experiment":
        existing = self.ledger.load_experiment(self.name)
        if existing is None:
            if self.space is None:
                raise ValueError(
                    f"experiment {self.name!r} does not exist and no space given"
                )
            doc = {
                "name": self.name,
                "space": self.space.configuration,
                "algorithm": self.algorithm,
                "max_trials": self.max_trials,
                "pool_size": self.pool_size,
                "metadata": {**fetch_metadata(self.user_args), **self.metadata},
                "user_args": self.user_args,
                "version": self.version,
            }
            try:
                self.ledger.create_experiment(doc)
                log.info("created experiment %r", self.name)
                self._configured = True
                return self
            except DuplicateExperimentError:
                existing = self.ledger.load_experiment(self.name)  # lost the race

        # adopt the stored configuration (reference semantics: joiners defer)
        assert existing is not None
        requested_meta = dict(self.metadata)
        self.space = build_space(existing["space"])
        self.algorithm = existing["algorithm"]
        self.max_trials = existing.get("max_trials", self.max_trials)
        self.pool_size = existing.get("pool_size", self.pool_size)
        self.metadata = existing.get("metadata", {})
        self.user_args = existing.get("user_args", self.user_args)
        self.version = existing.get("version", 1)
        if (requested_meta.get("warm_start")
                and "warm_start" not in self.metadata):
            # a re-attach asking for warm start must not silently lose it:
            # persist the request into the stored doc so every worker's
            # producer sees it
            self.metadata["warm_start"] = requested_meta["warm_start"]
            self.ledger.update_experiment(
                self.name, {"metadata": self.metadata}
            )
        log.info("loaded experiment %r (%d trials on ledger)",
                 self.name, self.ledger.count(self.name))
        self._configured = True
        return self

    # -- trial operations -------------------------------------------------
    def make_trial(self, params: Dict[str, Any], parent: Optional[str] = None) -> Trial:
        assert self.space is not None
        # hash before constructing: an id-less Trial would compute (and
        # immediately discard) its own params hash in __post_init__. With
        # no fidelity axis the id and lineage hashes are the same value.
        tid = self.space.hash_point(params, with_fidelity=True)
        lineage = (
            tid if self.space.fidelity is None
            else self.space.hash_point(params)
        )
        return Trial(
            params=dict(params), experiment=self.name, parent=parent,
            id=tid, lineage=lineage,
        )

    def register_trials(self, trials: List[Trial]) -> List[Trial]:
        """Register suggestions; duplicates (lost suggestion races) dropped."""
        kept = []
        for t in trials:
            try:
                self.ledger.register(t)
                kept.append(t)
            except DuplicateTrialError:
                log.debug("dropped duplicate suggestion %s", t.id)
        return kept

    def reserve_trial(self, worker: str = "worker-0") -> Optional[Trial]:
        return self.ledger.reserve(self.name, worker)

    def fetch_trials(self, status=None) -> List[Trial]:
        return self.ledger.fetch(self.name, status)

    def fetch_completed_since(self, cursor=None):
        """(newly completed trials, next cursor) — the Producer hot path."""
        return self.ledger.fetch_completed_since(self.name, cursor)

    def fetch_completed_trials(self) -> List[Trial]:
        return self.ledger.fetch(self.name, "completed")

    def count(self, status=None) -> int:
        return self.ledger.count(self.name, status)

    def push_results(self, trial: Trial, results: List[Dict[str, Any]],
                     status: str = "completed") -> bool:
        trial.attach_results(results)
        trial.transition(status)
        return self.ledger.update_trial(
            trial, expected_status="reserved", expected_worker=trial.worker
        )

    # -- completion -------------------------------------------------------
    @property
    def is_done(self) -> bool:
        # refresh the budget from the ledger so a live `mtpu db set -n X
        # max_trials=N` takes effect in running workers' workon loops —
        # the doc round-trip is already paid for algo_done below
        doc = self.ledger.load_experiment(self.name)
        if doc and doc.get("max_trials") is not None:
            self.max_trials = doc["max_trials"]
        if self.count("completed") >= self.max_trials:
            return True
        if not (doc and doc.get("algo_done")):
            return False
        # the algorithm has nothing more to SUGGEST, but already-registered
        # trials still deserve execution — an exhausted grid/space must not
        # strand its queued work
        return self.count(("new", "reserved")) == 0

    def mark_algo_done(self) -> None:
        self.ledger.update_experiment(self.name, {"algo_done": True})

    @property
    def stats(self) -> Dict[str, Any]:
        trials = self.fetch_trials()
        by_status: Dict[str, int] = {}
        for t in trials:
            by_status[t.status] = by_status.get(t.status, 0) + 1
        completed = [t for t in trials if t.status == "completed"]
        best = None
        if completed:
            best_t = min(
                (t for t in completed if t.objective is not None),
                key=lambda t: t.objective,
                default=None,
            )
            if best_t:
                best = {"id": best_t.id, "objective": best_t.objective,
                        "params": best_t.params}
        return {
            "name": self.name,
            "trials": len(trials),
            "by_status": by_status,
            "max_trials": self.max_trials,
            "best": best,
        }
