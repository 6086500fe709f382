"""Finite-step gradient descent over reported gradients.

Port of ``metaopt_tpu/algo/gradient_descent.py``, unchanged: the lineage's
demo algorithm that consumes ``gradient``-typed results, kept to exercise
the typed-results protocol end to end. The first point is a prior draw;
each later one steps ``learning_rate`` against the last reported gradient,
clamped into the space. Real-dimension spaces only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Real, Space


@algo_registry.register("gradientdescent")
@algo_registry.register("gradient_descent")
class GradientDescent(BaseAlgorithm):
    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        learning_rate: float = 0.1,
        **config: Any,
    ):
        super().__init__(space, seed=seed, learning_rate=learning_rate, **config)
        if not all(isinstance(d, Real) for d in space.searchable):
            raise ValueError("gradient_descent supports Real dimensions only")
        self.learning_rate = learning_rate
        self._current: Optional[np.ndarray] = None  # last observed point
        self._gradient: Optional[np.ndarray] = None

    @property
    def _names(self) -> List[str]:
        return [d.name for d in self.space.searchable]

    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        if self._current is None or self._gradient is None:
            return self.space.sample(1, seed=self.rng)
        nxt = self._current - self.learning_rate * self._gradient
        # clamp into the space
        for i, d in enumerate(self.space.searchable):
            low, high = d.interval()
            nxt[i] = min(max(nxt[i], low), high)
        return [dict(zip(self._names, (float(v) for v in nxt)))]

    def _observe_one(self, trial: Trial) -> None:
        grad = trial.gradient
        if grad is None:
            return
        self._current = np.asarray(
            [float(trial.params[n]) for n in self._names], dtype=float
        )
        self._gradient = np.asarray(grad.value, dtype=float)

    @property
    def is_done(self) -> bool:
        if self._gradient is not None and float(np.linalg.norm(self._gradient)) < 1e-7:
            return True
        return super().is_done

    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["current"] = None if self._current is None else self._current.tolist()
        s["gradient"] = None if self._gradient is None else self._gradient.tolist()
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        cur, grad = state.get("current"), state.get("gradient")
        self._current = None if cur is None else np.asarray(cur, dtype=float)
        self._gradient = None if grad is None else np.asarray(grad, dtype=float)
