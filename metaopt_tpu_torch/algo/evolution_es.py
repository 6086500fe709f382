"""EvolutionES — population-based evolution on the fidelity ladder.

Port of ``metaopt_tpu/algo/evolution_es.py``, unchanged: a population of
``population_size`` lineages runs at each generation's budget; once every
lineage of a generation has a result, the top half (stable sort by
objective) survives, and the next generation is made of mutated copies of
the survivors at the next rung's budget. Mutation perturbs each searchable
dimension with probability ``mutate_prob`` by a Gaussian step of width
``mutate_scale`` in the unit cube (categoricals resample uniformly).

It draws with numpy only, in the reference's order (the survivor by
``rng.integers``, then per dimension ``rng.random()`` and, when mutating,
``rng.normal``), so the same seed and stream of observations give the
reference's suggestions exactly.

Config: ``seed``, ``population_size``, ``mutate_prob``, ``mutate_scale``,
``max_generations``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space, UnitCube

log = logging.getLogger(__name__)


@algo_registry.register("evolutiones")
@algo_registry.register("evolution_es")
class EvolutionES(BaseAlgorithm):
    requires_fidelity = True

    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        population_size: int = 20,
        mutate_prob: float = 0.3,
        mutate_scale: float = 0.2,
        max_generations: Optional[int] = None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            population_size=population_size,
            mutate_prob=mutate_prob,
            mutate_scale=mutate_scale,
            max_generations=max_generations,
            **config,
        )
        fid = space.fidelity  # requires_fidelity: BaseAlgorithm checked it
        self.fidelity_name = fid.name
        self.population_size = int(population_size)
        if self.population_size < 2:
            raise ValueError("population_size must be >= 2")
        self.mutate_prob = float(mutate_prob)
        self.mutate_scale = float(mutate_scale)
        self.budgets = fid.rungs()
        self.max_generations = max_generations
        self.cube = UnitCube(space)

        self.generation = 0
        self._assigned: Set[str] = set()     # lineages issued this generation
        self._results: Dict[str, Tuple[float, Dict[str, Any]]] = {}
        self._survivors: List[Dict[str, Any]] = []  # seeds for next generation

    def _budget(self) -> int:
        """Budget ramps up the fidelity ladder as generations progress."""
        return self.budgets[min(self.generation, len(self.budgets) - 1)]

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        lineage = trial.lineage or self.space.hash_point(trial.params)
        self._assigned.add(lineage)  # absorbs strays (replay, insert)
        obj = float(trial.objective)
        cur = self._results.get(lineage)
        if cur is None or obj < cur[0]:
            self._results[lineage] = (obj, dict(trial.params))

    # -- suggest -----------------------------------------------------------
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for _ in range(num):
            pt = self._suggest_one()
            if pt is None:
                break  # generation barrier: wait for the population
            out.append(pt)
        return out

    @property
    def cohort_size(self) -> int:
        # one generation = one same-fidelity evaluation pool
        return self.population_size

    def _suggest_one(self) -> Optional[Dict[str, Any]]:
        # generation complete? select survivors and advance
        if (
            len(self._assigned) >= self.population_size
            and len(self._results) >= self.population_size
        ):
            self._advance_generation()
        if (
            self.max_generations is not None
            and self.generation >= self.max_generations
        ):
            return None
        if len(self._assigned) >= self.population_size:
            return None  # population fully issued; waiting on results

        budget = self._budget()
        for _ in range(100):
            if self._survivors:
                seed_pt = self._survivors[
                    int(self.rng.integers(len(self._survivors)))
                ]
                pt = self._mutate(seed_pt)
            else:
                pt = self.space.sample(1, seed=self.rng)[0]
            pt[self.fidelity_name] = budget
            lineage = self.space.hash_point(pt)
            if lineage not in self._assigned:
                self._assigned.add(lineage)
                return pt
        return None

    def _advance_generation(self) -> None:
        ranked = sorted(self._results.items(), key=lambda kv: kv[1][0])
        keep = max(1, self.population_size // 2)
        self._survivors = [dict(params) for _, (_, params) in ranked[:keep]]
        self.generation += 1
        self._assigned.clear()
        self._results.clear()
        log.debug(
            "evolution_es generation %d: %d survivors, budget %d",
            self.generation, len(self._survivors), self._budget(),
        )

    def _mutate(self, params: Dict[str, Any]) -> Dict[str, Any]:
        vec = self.cube.transform(params)
        for j in range(self.cube.n_dims):
            if self.rng.random() >= self.mutate_prob:
                continue
            if self.cube.categorical_mask[j]:
                vec[j] = self.rng.random()  # resample the category
            else:
                vec[j] = float(
                    np.clip(vec[j] + self.rng.normal(0, self.mutate_scale), 1e-6, 1 - 1e-6)
                )
        return self.cube.untransform(vec)

    @property
    def is_done(self) -> bool:
        if self.max_generations is not None:
            return self.generation >= self.max_generations
        return super().is_done

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["generation"] = self.generation
        s["assigned"] = sorted(self._assigned)
        s["results"] = {k: [v[0], v[1]] for k, v in self._results.items()}
        s["survivors"] = [dict(p) for p in self._survivors]
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.generation = state.get("generation", 0)
        self._assigned = set(state.get("assigned", []))
        self._results = {
            k: (float(v[0]), dict(v[1]))
            for k, v in state.get("results", {}).items()
        }
        self._survivors = [dict(p) for p in state.get("survivors", [])]
