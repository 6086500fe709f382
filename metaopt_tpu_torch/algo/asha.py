"""ASHA — asynchronous successive halving.

Port of ``metaopt_tpu/algo/asha.py``, unchanged: rungs keyed by fidelity
level; on ``suggest``, promote the best not-yet-promoted trial from the
highest rung that can promote, else sample a new bottom-rung point. No
bracket barrier — fully asynchronous (promotions are just new trials with
the same lineage at the next budget). It draws with numpy only
(``space.sample(1, seed=self.rng)``), so the same seed and the same stream
of observations give the reference's suggestions exactly.

Config: ``seed``, ``num_rungs``, ``num_brackets``, ``reduction_factor``
(defaults to the fidelity dimension's ``base``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Set, Tuple

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space

log = logging.getLogger(__name__)


class Rung:
    """One fidelity level's completed results, keyed by lineage hash."""

    def __init__(self, budget: int):
        self.budget = budget
        self.results: Dict[str, Tuple[float, Dict[str, Any]]] = {}
        self.promoted: Set[str] = set()

    def record(self, lineage: str, objective: float, params: Dict[str, Any]) -> None:
        cur = self.results.get(lineage)
        if cur is None or objective < cur[0]:
            self.results[lineage] = (objective, dict(params))

    def promotable(self, eta: int) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Best not-yet-promoted lineage within the top 1/eta, else None."""
        k = len(self.results) // eta
        if k == 0:
            return None
        ranked = sorted(self.results.items(), key=lambda kv: kv[1][0])
        for lineage, (_, params) in ranked[:k]:
            if lineage not in self.promoted:
                return lineage, params
        return None


class Bracket:
    """A ladder of rungs from some base budget up to the max budget."""

    def __init__(self, budgets: List[int]):
        self.rungs = [Rung(b) for b in budgets]

    def rung_for(self, budget: int) -> Optional[Rung]:
        for r in self.rungs:
            if r.budget == budget:
                return r
        return None

    def promote(self, eta: int) -> Optional[Tuple[Dict[str, Any], int]]:
        """(params, next budget) from the highest promotable rung, else None."""
        for i in range(len(self.rungs) - 2, -1, -1):
            cand = self.rungs[i].promotable(eta)
            if cand is not None:
                lineage, params = cand
                self.rungs[i].promoted.add(lineage)
                return params, self.rungs[i + 1].budget
        return None


@algo_registry.register("asha")
class ASHA(BaseAlgorithm):
    requires_fidelity = True

    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        num_rungs: Optional[int] = None,
        num_brackets: int = 1,
        reduction_factor: Optional[int] = None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            num_rungs=num_rungs,
            num_brackets=num_brackets,
            reduction_factor=reduction_factor,
            **config,
        )
        fid = space.fidelity  # requires_fidelity: BaseAlgorithm checked it
        self.fidelity_name = fid.name
        self.eta = int(reduction_factor or fid.base)
        if self.eta < 2:
            raise ValueError(f"reduction_factor must be >= 2, got {self.eta}")
        budgets = fid.rungs()
        if num_rungs is not None:
            budgets = budgets[-num_rungs:] if num_rungs <= len(budgets) else budgets
        if num_brackets > len(budgets):
            raise ValueError(
                f"num_brackets={num_brackets} exceeds {len(budgets)} rungs"
            )
        #: bracket s starts s rungs up the ladder (bracket 0 = full ladder)
        self.brackets = [Bracket(budgets[s:]) for s in range(num_brackets)]
        self._suggested: Set[Tuple[str, int]] = set()  # (lineage, budget) dedup

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        budget = int(trial.params[self.fidelity_name])
        lineage = trial.lineage or self.space.hash_point(trial.params)
        # attribute to the first bracket holding this budget (covers our own
        # suggestions, ledger replays, and manual inserts alike; with multiple
        # brackets sharing a budget the lowest bracket absorbs strays)
        for bracket in self.brackets:
            rung = bracket.rung_for(budget)
            if rung is not None:
                self._suggested.add((lineage, budget))
                rung.record(lineage, float(trial.objective), trial.params)
                return

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
        # 1. try promotion, preferring the fullest ladder
        for bracket in self.brackets:
            promo = bracket.promote(self.eta)
            if promo is not None:
                params, budget = promo
                params = dict(params)
                params[self.fidelity_name] = budget
                lineage = self.space.hash_point(params)
                self._suggested.add((lineage, budget))
                log.debug("ASHA promotes %s to budget %d", lineage[:8], budget)
                return params
        # 2. else a fresh bottom-rung sample in a (weighted-random) bracket
        bracket = self.brackets[
            int(self.rng.integers(len(self.brackets)))
        ]
        base_budget = bracket.rungs[0].budget
        for _ in range(100):  # resample on lineage collision
            pt = self.space.sample(1, seed=self.rng)[0]
            pt[self.fidelity_name] = base_budget
            lineage = self.space.hash_point(pt)
            if (lineage, base_budget) not in self._suggested:
                self._suggested.add((lineage, base_budget))
                return pt
        return None

    # -- introspection ------------------------------------------------------
    @property
    def rung_table(self) -> List[Dict[str, Any]]:
        """Rung occupancy (for `status` displays and tests)."""
        out = []
        for bi, bracket in enumerate(self.brackets):
            for rung in bracket.rungs:
                out.append(
                    {
                        "bracket": bi,
                        "budget": rung.budget,
                        "n": len(rung.results),
                        "promoted": len(rung.promoted),
                    }
                )
        return out

    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["suggested"] = sorted(list(t) for t in self._suggested)
        s["brackets"] = [
            [
                {
                    "budget": r.budget,
                    "results": {k: [v[0], v[1]] for k, v in r.results.items()},
                    "promoted": sorted(r.promoted),
                }
                for r in b.rungs
            ]
            for b in self.brackets
        ]
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._suggested = {tuple(t) for t in state.get("suggested", [])}
        dumped = state.get("brackets")
        if dumped:
            for bracket, bdump in zip(self.brackets, dumped):
                for rung, rdump in zip(bracket.rungs, bdump):
                    rung.results = {
                        k: (float(v[0]), dict(v[1]))
                        for k, v in rdump["results"].items()
                    }
                    rung.promoted = set(rdump["promoted"])
