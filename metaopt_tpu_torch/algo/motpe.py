"""Multi-objective TPE (MOTPE).

Port of ``metaopt_tpu/algo/motpe.py``, unchanged (Ozaki et al., 2020):
TPE's scalar γ-quantile split becomes a split by Pareto nondomination.
TPE uses y only ordinally, so the Pareto ordering is compressed on the
host into a scalar pseudo-objective

    key = nondominated_rank + 0.5 · (1 − normalized crowding distance)

(the NSGA-II ordering: strictly better fronts sort strictly first; within
a front, isolated points sort first so the good set keeps coverage of the
whole front). That scalar feeds the port's TPE unchanged, so the EI
launches run :func:`~metaopt_tpu_torch.ops.tpe_math.tpe_suggest_fused` on
TPE's device (``cuda`` unless ``device`` says otherwise). The ranking is
exact host numpy, O(n²·m) per batch of observations.

Trials report their objective vector as multiple ``objective``-typed
results (``client.report_results`` order = vector order);
``Trial.objectives`` exposes it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from metaopt_tpu_torch.algo.base import algo_registry
from metaopt_tpu_torch.algo.tpe import TPE
from metaopt_tpu_torch.ledger.trial import Trial

log = logging.getLogger(__name__)


def nondominated_ranks(F: np.ndarray) -> np.ndarray:
    """Front index per point (0 = Pareto front) for minimized objectives.

    Front peeling over the full domination matrix — O(n²·m) vectorized,
    exact (no fast-nondominated-sort bookkeeping to get subtly wrong).
    """
    n = len(F)
    ranks = np.full(n, -1, dtype=np.int64)
    # dom[a, b]: a dominates b (≤ everywhere, < somewhere)
    le = np.all(F[:, None, :] <= F[None, :, :], axis=2)
    lt = np.any(F[:, None, :] < F[None, :, :], axis=2)
    dom = le & lt
    remaining = np.ones(n, dtype=bool)
    r = 0
    while remaining.any():
        dominated = (dom & remaining[:, None]).any(axis=0)
        front = remaining & ~dominated
        if not front.any():  # unreachable (a finite strict order has minima)
            front = remaining
        ranks[front] = r
        remaining &= ~front
        r += 1
    return ranks


def crowding_distance(F: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front (∞ at the extremes)."""
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    crowd = np.zeros(n)
    for j in range(m):
        order = np.argsort(F[:, j], kind="stable")
        span = F[order[-1], j] - F[order[0], j]
        crowd[order[0]] = crowd[order[-1]] = np.inf
        if span <= 0:
            continue  # degenerate objective: contributes nothing
        gaps = (F[order[2:], j] - F[order[:-2], j]) / span
        crowd[order[1:-1]] += gaps
    return crowd


def pareto_order_keys(F: np.ndarray) -> np.ndarray:
    """Scalar pseudo-objective realizing the NSGA-II total preorder.

    Lower = better. ``key ∈ [rank, rank + 0.5]``, so no two fronts ever
    interleave; within a front higher crowding (more isolated) maps to a
    lower key, keeping the γ-split's good set spread across the front.
    """
    F = np.asarray(F, dtype=np.float64)
    ranks = nondominated_ranks(F)
    keys = ranks.astype(np.float64)
    for r in range(int(ranks.max()) + 1):
        idx = np.where(ranks == r)[0]
        crowd = crowding_distance(F[idx])
        finite = crowd[np.isfinite(crowd)]
        top = float(finite.max()) if len(finite) else 0.0
        cn = np.where(np.isinf(crowd), 1.0,
                      crowd / top if top > 0 else 0.0)
        keys[idx] += 0.5 * (1.0 - cn)
    return keys


@algo_registry.register("motpe")
class MOTPE(TPE):
    """TPE over the NSGA-II pseudo-objective; config adds ``n_objectives``."""

    def __init__(
        self,
        space,
        seed: Optional[int] = None,
        n_objectives: int = 2,
        **config: Any,
    ):
        super().__init__(space, seed=seed, **config)
        if n_objectives < 2:
            raise ValueError(
                f"motpe needs n_objectives >= 2, got {n_objectives} "
                "(use tpe for single-objective searches)"
            )
        self._config["n_objectives"] = int(n_objectives)
        self.n_objectives = int(n_objectives)
        self._F: List[List[float]] = []  # objective vectors, observation order
        self._keys_dirty = False

    # -- observe -----------------------------------------------------------
    def observe(self, trials) -> None:
        # one O(n²·m) ranking per BATCH, not per trial: _observe_one only
        # marks dirty; the rebuild runs once before the speculative refill
        # (which fits on self._y) can fire
        with self._kernel_lock:
            super().observe(trials)
            if self._keys_dirty:
                self._rebuild_keys()
                self._keys_dirty = False

    def _observe_one(self, trial: Trial) -> None:
        objs = [float(v) for v in trial.objectives[: self.n_objectives]]
        if len(objs) < self.n_objectives or not np.all(np.isfinite(objs)):
            # a short vector cannot be ranked against the others, and a
            # NaN one would rank UNbeatable (all NaN comparisons are False
            # → never dominated → permanent front-0 with the best key) —
            # the opposite of scalar TPE, where argsort sends NaN to the
            # bad set. Either way the trial stays observed
            # (replay-idempotent) but unfitted.
            log.warning(
                "motpe: trial %s reported objectives %r, need %d finite — "
                "excluded from the Parzen fit", trial.id, trial.objectives,
                self.n_objectives,
            )
            return
        self._X.append(self.cube.transform(trial.params))
        self._F.append(objs)
        self._keys_dirty = True

    def _rebuild_keys(self) -> None:
        """Recompute every pseudo-objective; ranks shift on each insert."""
        if not self._F:
            self._y = []
            return
        self._y = list(pareto_order_keys(np.asarray(self._F)))
        # ranks shift for EXISTING rows too, and the incremental buffer
        # only appends missing rows — without this the device mirror keeps
        # serving the pseudo-objectives of an earlier Pareto ordering
        self._buf.mark_stale()
        self._aug_key = None  # overlay composed over the stale base

    # -- observability -----------------------------------------------------
    def pareto_front(self) -> List[Tuple[Dict[str, Any], List[float]]]:
        """Current nondominated set as ``(params, objective_vector)`` pairs."""
        if not self._F:
            return []
        with self._kernel_lock:
            F = np.asarray(self._F)
            ranks = nondominated_ranks(F)
            return [
                (self.cube.untransform(self._X[i]), list(self._F[i]))
                for i in np.where(ranks == 0)[0]
            ]

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        # launch -> kernel, in TPE's documented order: super().state_dict
        # takes BOTH locks (RLocks nest, so re-acquiring is free), and
        # grabbing the kernel lock alone first AB-BA-deadlocks against the
        # speculative-refill thread, which holds launch while waiting for
        # kernel. ONE acquisition still spans both snapshots: a concurrent
        # observe() between them would serialize an F one row longer than
        # X/y, and restoring that state crashes _sync_device
        with self._launch_lock, self._kernel_lock:
            s = super().state_dict()
            s["F"] = [list(f) for f in self._F]
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        # launch -> kernel for the same reason as state_dict above
        with self._launch_lock, self._kernel_lock:
            super().load_state_dict(state)
            self._F = [list(f) for f in state.get("F", [])]
            if self._F:
                # the serialized y is the pseudo-objective (derived data);
                # rebuild from F so the two can never drift apart
                self._rebuild_keys()
