"""The algorithm contract (port of ``metaopt_tpu/algo/base.py``).

Trimmed to what random search on the ``workon`` path reaches:
``suggest(num)``, ``observe(trials)``, ``is_done``, the ``judge`` early-stop
hook, the registry and :func:`make_algorithm`. Not ported
yet: the suggest-ahead mixin (``SuggestAhead``), the fleet-fused hooks
(``FuseSnapshot``, ``fuse_*``), transfer priors (``observe_prior``), the
parallel-strategy ``set_pending``, suspension, ``score``, ``seed_rng`` and
the ``state_dict`` snapshots; they serve TPE, GP-BO, the multi-fidelity
algorithms and the coordinator.

``observe`` takes :class:`~metaopt_tpu_torch.ledger.trial.Trial` objects
(they carry params, objective, fidelity, status, and lineage in one value
object) instead of parallel points/results lists.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space
from metaopt_tpu_torch.utils.registry import Registry

algo_registry: Registry = Registry("algorithm")


class BaseAlgorithm(ABC):
    """Pluggable optimizer over a :class:`Space`.

    The Producer drives it: ``observe(completed_trials)`` then
    ``suggest(num)``; both must be cheap relative to trial runtime, and
    ``suggest`` may return fewer points than asked (or none, when the
    algorithm is waiting on in-flight trials — e.g. ASHA rungs full).
    """

    def __init__(self, space: Space, seed: Optional[int] = None, **config: Any):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self._observed: Dict[str, float] = {}  # trial id -> objective

    # -- core contract ----------------------------------------------------
    @abstractmethod
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        """Propose up to ``num`` new points (param dicts incl. fidelity)."""

    def observe(self, trials: Sequence[Trial]) -> None:
        """Ingest completed trials. Idempotent per trial id (replay-safe)."""
        for t in trials:
            if t.id in self._observed:
                continue
            obj = t.objective
            if obj is None:
                continue
            self._observed[t.id] = obj

    @property
    def n_observed(self) -> int:
        return len(self._observed)

    @property
    def is_done(self) -> bool:
        """True when the algorithm cannot usefully continue (space exhausted)."""
        return self.n_observed >= self.space.cardinality

    def judge(self, trial: Trial, partial: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """Dynamic early-stop hook: given streaming partial results
        (``[{"objective": ..., "step": ...}, ...]``), return ``{"stop":
        True}`` to prune the running trial, or None to let it run."""
        return None


def _load_plugin(name: str) -> bool:
    """Third-party discovery (the lineage's pkg_resources plugin role).

    An installed distribution can expose algorithms via the
    ``metaopt_tpu_torch.algorithms`` entry-point group; loading the entry point
    imports the module, whose ``@algo_registry.register`` decorator does
    the rest. Returns True if something matching ``name`` was loaded.
    """
    try:
        from importlib.metadata import entry_points

        eps = list(entry_points(group="metaopt_tpu_torch.algorithms"))
    except Exception:  # discovery failure must not mask the KeyError
        return False
    for ep in eps:
        if ep.name.lower() == name.lower():
            # load OUTSIDE the guard: a plugin that fails to import must
            # surface ITS error, not a bare unknown-algorithm KeyError
            ep.load()
            return name.lower() in algo_registry
    return False


def make_algorithm(space: Space, config: Dict[str, Any]) -> BaseAlgorithm:
    """Build from ``{"asha": {...}}``-style config (single key = algo name)."""
    if len(config) != 1:
        raise ValueError(f"algorithm config must have exactly one key, got {config}")
    (name, kwargs), = config.items()
    try:
        cls = algo_registry.get(name)
    except KeyError:
        if not _load_plugin(name):
            raise
        cls = algo_registry.get(name)
    return cls(space, **(kwargs or {}))
