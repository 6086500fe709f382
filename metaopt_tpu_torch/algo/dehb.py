"""DEHB — Differential Evolution Hyperband.

Port of ``metaopt_tpu/algo/dehb.py``, unchanged (Awad et al., 2021). A
differential-evolution subpopulation lives at every rung of the fidelity
ladder. New low-rung members are DE offspring — mutant = a + F·(b − c)
over three distinct members, binomial crossover against a round-robin
target — evaluated at the rung's budget; higher-rung populations are
seeded by promoting the best not-yet-promoted members from the rung below.
Everything happens in the unit cube. As in the reference, it is
asynchronous in the ASHA style (promote-when-ready, no bracket barrier)
rather than the paper's synchronized brackets.

It draws with numpy only, in the reference's order, so the same seed and
stream of observations give the reference's suggestions exactly.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space, UnitCube

log = logging.getLogger(__name__)


@algo_registry.register("dehb")
class DEHB(BaseAlgorithm):
    """Async DE-over-Hyperband on the fidelity ladder.

    Config:
      population_size: size of the initial random population at the base
        rung; also caps the DE donor/target pool to the best that many
        members (lazy selection — stragglers fall out of the pool).
      mutation_factor: F in mutant = a + F·(b − c).
      crossover_prob: per-dimension probability of taking the mutant value.
      reduction_factor: promotions per rung = top 1/eta (default: fidelity
        base).
    """

    requires_fidelity = True

    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        population_size: int = 20,
        mutation_factor: float = 0.5,
        crossover_prob: float = 0.5,
        reduction_factor: Optional[int] = None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            population_size=population_size,
            mutation_factor=mutation_factor,
            crossover_prob=crossover_prob,
            reduction_factor=reduction_factor,
            **config,
        )
        fid = space.fidelity
        assert fid is not None
        self.fidelity_name = fid.name
        self.population_size = int(population_size)
        if self.population_size < 4:
            raise ValueError("population_size must be >= 4 (DE needs a+b+c+target)")
        self.f = float(mutation_factor)
        self.cr = float(crossover_prob)
        self.eta = int(reduction_factor or fid.base)
        if self.eta < 2:
            raise ValueError(f"reduction_factor must be >= 2, got {self.eta}")
        self.budgets = fid.rungs()
        self.cube = UnitCube(space)

        #: rung index -> lineage -> (objective, unit-cube vector)
        self._rungs: List[Dict[str, Tuple[float, List[float]]]] = [
            {} for _ in self.budgets
        ]
        self._issued: Set[Tuple[str, int]] = set()
        self._promoted: List[Set[str]] = [set() for _ in self.budgets]
        self._target_counter = 0

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        budget = int(trial.params[self.fidelity_name])
        try:
            ri = self.budgets.index(budget)
        except ValueError:
            below = [i for i, b in enumerate(self.budgets) if b <= budget]
            if not below:
                return
            ri = below[-1]
        lineage = trial.lineage or self.space.hash_point(trial.params)
        self._issued.add((lineage, self.budgets[ri]))
        # UnitCube.transform reads only non-fidelity dims by name
        vec = [float(v) for v in self.cube.transform(trial.params)]
        obj = float(trial.objective)
        cur = self._rungs[ri].get(lineage)
        if cur is None or obj < cur[0]:
            self._rungs[ri][lineage] = (obj, vec)

    # -- suggest -----------------------------------------------------------
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for _ in range(num):
            pt = self._suggest_one()
            if pt is None:
                break
            out.append(pt)
        return out

    def _suggest_one(self) -> Optional[Dict[str, Any]]:
        # 1. promote into higher rungs whenever a lower rung can afford it
        for ri in range(len(self.budgets) - 2, -1, -1):
            pt = self._try_promote(ri)
            if pt is not None:
                return pt
        # 2. grow/evolve the base-rung population
        return self._base_rung_offspring()

    def _try_promote(self, ri: int) -> Optional[Dict[str, Any]]:
        """Top-1/eta of rung ri, not yet promoted, seeds rung ri+1."""
        rung = self._rungs[ri]
        k = len(rung) // self.eta
        if k == 0:
            return None
        ranked = sorted(rung.items(), key=lambda kv: kv[1][0])
        for lineage, (_, vec) in ranked[:k]:
            if lineage in self._promoted[ri]:
                continue
            params = self.cube.untransform(list(vec))
            params[self.fidelity_name] = self.budgets[ri + 1]
            new_lineage = self.space.hash_point(params)
            if (new_lineage, self.budgets[ri + 1]) in self._issued:
                self._promoted[ri].add(lineage)
                continue
            self._promoted[ri].add(lineage)
            self._issued.add((new_lineage, self.budgets[ri + 1]))
            return params
        return None

    def _base_rung_offspring(self) -> Optional[Dict[str, Any]]:
        base_budget = self.budgets[0]
        issued_base = sum(1 for _, b in self._issued if b == base_budget)
        bootstrap = issued_base < self.population_size
        if not bootstrap and len(self._rungs[0]) < 4:
            return None  # initial population still in flight; DE must wait
        for _ in range(100):
            if bootstrap:
                vec = [float(self.rng.random()) for _ in range(self.cube.n_dims)]
            else:
                vec = self._de_offspring(self._rungs[0])
            params = self.cube.untransform(vec)
            params[self.fidelity_name] = base_budget
            lineage = self.space.hash_point(params)
            if (lineage, base_budget) not in self._issued:
                self._issued.add((lineage, base_budget))
                return params
        return None

    def _de_offspring(self, pop: Dict[str, Tuple[float, List[float]]]) -> List[float]:
        # the evolving subpopulation is the best `population_size` members —
        # the selection step of DE, applied lazily (stragglers fall out of
        # the donor/target pool instead of being overwritten in place)
        members = sorted(pop.values(), key=lambda m: m[0])[:self.population_size]
        # round-robin target (the member the offspring challenges) + three
        # distinct donors drawn from the REST of the pool, rand/1 scheme
        self._target_counter += 1
        t_idx = self._target_counter % len(members)
        target = members[t_idx][1]
        donors = [i for i in range(len(members)) if i != t_idx]
        idx = self.rng.choice(len(donors), size=3, replace=False)
        a, b, c = (members[donors[int(i)]][1] for i in idx)
        j_rand = int(self.rng.integers(self.cube.n_dims))
        vec: List[float] = []
        for j in range(self.cube.n_dims):
            if j == j_rand or self.rng.random() < self.cr:
                v = a[j] + self.f * (b[j] - c[j])
            else:
                v = target[j]
            vec.append(float(np.clip(v, 1e-6, 1 - 1e-6)))
        return vec

    # -- introspection ------------------------------------------------------
    @property
    def rung_table(self) -> List[Dict[str, Any]]:
        return [
            {"bracket": 0, "budget": b, "n": len(r),
             "promoted": len(self._promoted[i])}
            for i, (b, r) in enumerate(zip(self.budgets, self._rungs))
        ]

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["rungs"] = [
            {k: [v[0], list(v[1])] for k, v in r.items()} for r in self._rungs
        ]
        s["issued"] = sorted(list(t) for t in self._issued)
        s["promoted"] = [sorted(p) for p in self._promoted]
        s["target_counter"] = self._target_counter
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        rungs = state.get("rungs")
        if rungs is not None:
            self._rungs = [
                {k: (float(v[0]), [float(x) for x in v[1]])
                 for k, v in r.items()}
                for r in rungs
            ]
            while len(self._rungs) < len(self.budgets):
                self._rungs.append({})
        self._issued = {tuple(t) for t in state.get("issued", [])}
        promoted = state.get("promoted")
        if promoted is not None:
            self._promoted = [set(p) for p in promoted]
            while len(self._promoted) < len(self.budgets):
                self._promoted.append(set())
        self._target_counter = int(state.get("target_counter", 0))
