"""BOHB — Bayesian optimization (TPE) inside Hyperband brackets.

Port of ``metaopt_tpu/algo/bohb.py``, unchanged: Hyperband's bracket and
budget scheduling stays as it is; only the bottom rungs' points come from a
model. There is one :class:`~metaopt_tpu_torch.algo.tpe.TPE` per budget
(seeded ``seed + 17 * (i + 1)``), each fed only that budget's results.
Sampling uses the model of the HIGHEST budget that holds
``min_points_in_model`` observations (d + 2 by default), and a
``random_fraction`` of fills stays uniform; until a model is ready every
fill is uniform.

The port adds ``device``, forwarded to every TPE: their EI launches run on
``cuda`` unless the caller passes another device (``device="cpu"``);
without CUDA the constructor raises. ``device`` is not part of the
``configuration`` (that equals the reference's). The models are fed through
``TPE._observe_one`` directly, as the reference feeds them: the TPE's
observation buffer syncs from its host lists at the next launch, and its
suggest-ahead refill, which only ``TPE.observe`` fires, never runs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from metaopt_tpu_torch.algo.base import algo_registry
from metaopt_tpu_torch.algo.hyperband import Hyperband
from metaopt_tpu_torch.algo.tpe import TPE
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space


@algo_registry.register("bohb")
class BOHB(Hyperband):
    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        repetitions: Optional[int] = None,
        reduction_factor: Optional[int] = None,
        min_points_in_model: Optional[int] = None,
        random_fraction: float = 1 / 3,
        n_ei_candidates: int = 24,
        gamma: float = 0.25,
        device=None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            repetitions=repetitions,
            reduction_factor=reduction_factor,
            **config,
        )
        # re-record the BOHB-specific knobs in the serialized configuration
        self._config.update(
            min_points_in_model=min_points_in_model,
            random_fraction=random_fraction,
            n_ei_candidates=n_ei_candidates,
            gamma=gamma,
        )
        self.random_fraction = float(random_fraction)
        #: BOHB rule of thumb: d+2 observations before trusting a model
        self.min_points_in_model = int(
            min_points_in_model
            if min_points_in_model is not None
            else len([d for d in space.values() if d.type != "fidelity"]) + 2
        )
        #: one TPE per budget level, each fed only that budget's results
        self._models: Dict[int, TPE] = {
            b: TPE(
                space,
                seed=None if seed is None else seed + 17 * (i + 1),
                n_initial_points=self.min_points_in_model,
                n_ei_candidates=n_ei_candidates,
                gamma=gamma,
                device=device,
            )
            for i, b in enumerate(self.budgets)
        }

    # -- observe: Hyperband bookkeeping + per-budget model updates ---------
    def _observe_one(self, trial: Trial) -> None:
        super()._observe_one(trial)
        budget = int(trial.params[self.fidelity_name])
        model = self._models.get(budget)
        if model is not None:
            model._observe_one(trial)

    def _model_for_sampling(self) -> Optional[TPE]:
        """The trained model of the highest budget, per the BOHB rule."""
        for b in reversed(self.budgets):
            m = self._models.get(b)
            if m is not None and len(m._y) >= self.min_points_in_model:
                return m
        return None

    # -- sampling hook: Hyperband calls this to fill bottom rungs ----------
    def _sample_point(self) -> Dict[str, Any]:
        model = self._model_for_sampling()
        if model is None or self.rng.random() < self.random_fraction:
            return self.space.sample(1, seed=self.rng)[0]
        return model._suggest_ei(1)[0]

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["models"] = {str(b): m.state_dict() for b, m in self._models.items()}
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        for b_str, mstate in (state.get("models") or {}).items():
            model = self._models.get(int(b_str))
            if model is not None:
                model.load_state_dict(mstate)
