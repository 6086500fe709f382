"""Hyperband — bracketed synchronous successive halving.

Port of ``metaopt_tpu/algo/hyperband.py``, unchanged. The bracket table
comes from the fidelity range (R, eta): s_max = floor(log_eta(R / r_min));
bracket s ∈ {s_max..0} starts n(s) = ceil((s_max+1)/(s+1) · eta^s) trials
at budget R · eta^{-s}. Within a bracket a rung promotes its top 1/eta only
once ALL its trials have completed (the synchronous barrier that sets it
apart from ASHA); brackets repeat ``repetitions`` times (forever when
None). Observations of trials it did not suggest (a ledger replayed after
a restart, a manual insert) are absorbed into the bracket whose entry rung
has that budget, so a replay rebuilds the rungs; ``rung_table`` feeds
``status --rungs``.

It draws with numpy only (``space.sample(1, seed=self.rng)``), so the same
seed and stream of observations give the reference's suggestions exactly.
:class:`~metaopt_tpu_torch.algo.bohb.BOHB` overrides ``_sample_point``.

Config: ``seed``, ``repetitions``, ``reduction_factor`` (defaults to the
fidelity dimension's ``base``).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional, Set, Tuple

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space

log = logging.getLogger(__name__)


class SyncRung:
    def __init__(self, budget: int, capacity: int):
        self.budget = budget
        self.capacity = capacity          # how many trials this rung admits
        self.assigned: Set[str] = set()   # lineages suggested at this rung
        self.results: Dict[str, Tuple[float, Dict[str, Any]]] = {}

    @property
    def is_full(self) -> bool:
        return len(self.assigned) >= self.capacity

    @property
    def is_complete(self) -> bool:
        return self.is_full and set(self.results) >= self.assigned


class SyncBracket:
    """One Hyperband bracket: rung ladder with capacities n, n/eta, ..."""

    def __init__(self, budgets: List[int], n0: int, eta: int):
        self.eta = eta
        caps = [max(1, n0 // (eta ** i)) for i in range(len(budgets))]
        self.rungs = [SyncRung(b, c) for b, c in zip(budgets, caps)]

    def next_action(self) -> Optional[Tuple[str, Any]]:
        """("fill", rung) | ("promote", (params, budget)) | None if blocked."""
        if not self.rungs[0].is_full:
            return ("fill", self.rungs[0])
        for i, rung in enumerate(self.rungs[:-1]):
            nxt = self.rungs[i + 1]
            if rung.is_complete and not nxt.is_full:
                ranked = sorted(rung.results.items(), key=lambda kv: kv[1][0])
                for lineage, (_, params) in ranked[: nxt.capacity]:
                    if lineage not in nxt.assigned:
                        return ("promote", (dict(params), nxt.budget))
        return None

    @property
    def is_done(self) -> bool:
        return all(r.is_complete for r in self.rungs)


@algo_registry.register("hyperband")
class Hyperband(BaseAlgorithm):
    requires_fidelity = True

    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        repetitions: Optional[int] = None,
        reduction_factor: Optional[int] = None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            repetitions=repetitions,
            reduction_factor=reduction_factor,
            **config,
        )
        fid = space.fidelity  # requires_fidelity: BaseAlgorithm checked it
        self.fidelity_name = fid.name
        self.eta = int(reduction_factor or fid.base)
        if self.eta < 2:
            raise ValueError(f"reduction_factor must be >= 2, got {self.eta}")
        self.budgets = fid.rungs()
        self.repetitions = repetitions  # None = repeat forever
        self.s_max = len(self.budgets) - 1
        self._execution = 0
        self.brackets: List[SyncBracket] = []
        self._new_execution()
        self._lineage_bracket: Dict[Tuple[str, int], SyncBracket] = {}

    def _new_execution(self) -> None:
        """Lay out one full Hyperband round: brackets s_max .. 0."""
        self.brackets = []
        for s in range(self.s_max, -1, -1):
            n0 = int(math.ceil((self.s_max + 1) / (s + 1) * (self.eta ** s)))
            budgets = self.budgets[self.s_max - s:]
            self.brackets.append(SyncBracket(budgets, n0, self.eta))
        self._execution += 1
        log.debug(
            "hyperband execution %d: brackets %s",
            self._execution,
            [(len(b.rungs), b.rungs[0].capacity) for b in self.brackets],
        )

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        budget = int(trial.params[self.fidelity_name])
        lineage = trial.lineage or self.space.hash_point(trial.params)
        bracket = self._lineage_bracket.get((lineage, budget))
        if bracket is None:
            # stray (observe-replay after restart, manual insert): first try
            # a bracket that already assigned this lineage at this budget
            for b in self.brackets:
                for r in b.rungs:
                    if r.budget == budget and lineage in r.assigned:
                        bracket = b
                        break
                if bracket:
                    break
        if bracket is None:
            # absorb: adopt into a bracket whose ENTRY rung is this budget
            # (that's where a stray of this budget was born), then any
            # bracket with free capacity at this budget, then an
            # exact-capacity bracket — so replaying a completed ledger
            # reconstructs usable rung state. Entry-rung preference
            # matters: dropping a sibling bracket's trial into a higher
            # rung of an earlier bracket would occupy promotion slots the
            # earlier bracket's own top performers are entitled to.
            fallback = None
            for b in self.brackets:
                r0 = b.rungs[0]
                if r0.budget == budget and not r0.is_full:
                    bracket = b
                    break
            if bracket is None:
                for b in self.brackets:
                    for r in b.rungs:
                        if r.budget != budget:
                            continue
                        if not r.is_full:
                            bracket = b
                            break
                        fallback = fallback or b
                    if bracket:
                        break
            bracket = bracket or fallback
            if bracket is None:
                return
            for r in bracket.rungs:
                if r.budget == budget:
                    r.assigned.add(lineage)
            self._lineage_bracket[(lineage, budget)] = bracket
        for rung in bracket.rungs:
            if rung.budget == budget:
                cur = rung.results.get(lineage)
                obj = float(trial.objective)
                if cur is None or obj < cur[0]:
                    rung.results[lineage] = (obj, dict(trial.params))
                return

    # -- suggest -----------------------------------------------------------
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for _ in range(num):
            pt = self._suggest_one()
            if pt is None:
                break  # barrier: waiting on in-flight rungs
            out.append(pt)
        return out

    def _sample_point(self) -> Dict[str, Any]:
        """Bottom-rung sampling hook; BOHB overrides with model-guided draws."""
        return self.space.sample(1, seed=self.rng)[0]

    def _suggest_one(self) -> Optional[Dict[str, Any]]:
        if all(b.is_done for b in self.brackets):
            if self.repetitions is not None and self._execution >= self.repetitions:
                return None
            self._new_execution()
        for bracket in self.brackets:
            action = bracket.next_action()
            if action is None:
                continue
            kind, payload = action
            if kind == "fill":
                rung = payload
                for _ in range(100):
                    pt = self._sample_point()
                    pt[self.fidelity_name] = rung.budget
                    lineage = self.space.hash_point(pt)
                    key = (lineage, rung.budget)
                    if key not in self._lineage_bracket:
                        rung.assigned.add(lineage)
                        self._lineage_bracket[key] = bracket
                        return pt
                continue
            params, budget = payload
            params = dict(params)
            params[self.fidelity_name] = budget
            lineage = self.space.hash_point(params)
            for rung in bracket.rungs:
                if rung.budget == budget:
                    rung.assigned.add(lineage)
            self._lineage_bracket[(lineage, budget)] = bracket
            return params
        return None  # every bracket blocked on its barrier

    @property
    def is_done(self) -> bool:
        if self.repetitions is not None:
            return (
                self._execution >= self.repetitions
                and all(b.is_done for b in self.brackets)
            )
        return super().is_done

    # -- introspection / persistence ---------------------------------------
    @property
    def rung_table(self) -> List[Dict[str, Any]]:
        out = []
        for bi, bracket in enumerate(self.brackets):
            for rung in bracket.rungs:
                out.append(
                    {
                        "bracket": bi,
                        "budget": rung.budget,
                        "capacity": rung.capacity,
                        "assigned": len(rung.assigned),
                        "completed": len(rung.results),
                    }
                )
        return out

    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["execution"] = self._execution
        s["brackets"] = [
            [
                {
                    "budget": r.budget,
                    "capacity": r.capacity,
                    "assigned": sorted(r.assigned),
                    "results": {k: [v[0], v[1]] for k, v in r.results.items()},
                }
                for r in b.rungs
            ]
            for b in self.brackets
        ]
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._execution = state.get("execution", 1)
        dumped = state.get("brackets")
        if dumped:
            for bracket, bdump in zip(self.brackets, dumped):
                for rung, rdump in zip(bracket.rungs, bdump):
                    rung.assigned = set(rdump["assigned"])
                    rung.results = {
                        k: (float(v[0]), dict(v[1]))
                        for k, v in rdump["results"].items()
                    }
                    for lineage in rung.assigned:
                        self._lineage_bracket[(lineage, rung.budget)] = bracket
