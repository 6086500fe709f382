"""PBT — Population Based Training.

Port of ``metaopt_tpu/algo/pbt.py``, unchanged (Jaderberg et al.). A
fixed-size population of *members* trains in steps along the fidelity
ladder. When a member finishes a step it is continued at the next budget;
before continuing, underperformers **exploit** (adopt the params of a
randomly-chosen top performer at the same rung — and, via the
``Trial.parent`` link, its checkpoint) and **explore** (perturb the
adopted hyperparameters). Top performers continue unchanged.

Asynchronous, like ASHA: a member is continued the moment its step
completes, judged against whatever cohort has reached that rung. The
continuation trial's ``parent`` is the trial whose weights should be
loaded; the subprocess executor exposes it to the user script through
``METAOPT_TPU_TRIAL_INFO`` and ``client.checkpoint_paths()`` turns it into
the parent's checkpoint directory.

Suggested continuations carry the reserved ``_parent`` key, which the
Producer strips into ``Trial.parent`` before registration. The exploit
draw is seeded by a blake2b hash of the source trial's id, so a rebuilt
instance regenerates the identical continuation.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space, UnitCube

log = logging.getLogger(__name__)


def _exploit_seed(tid: str) -> int:
    """Process-stable RNG seed for one member's exploit/explore draw."""
    digest = hashlib.blake2b(
        f"{tid}:pbt-exploit".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


@algo_registry.register("pbt")
class PBT(BaseAlgorithm):
    """Asynchronous Population Based Training over the fidelity ladder.

    Config:
      population_size: members trained in parallel (slots, not processes).
      exploit_quantile: a member below this quantile of its rung cohort
        exploits a member above ``1 - exploit_quantile`` (default 0.25).
      min_cohort: smallest rung cohort before exploitation can trigger
        (below it, members always continue unchanged).
      perturb_scale: explore step width in the unit cube (numeric dims).
      resample_prob: per-dimension probability that explore resamples from
        the prior instead of perturbing (categoricals always resample).
    """

    requires_fidelity = True

    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        population_size: int = 16,
        exploit_quantile: float = 0.25,
        min_cohort: int = 3,
        perturb_scale: float = 0.2,
        resample_prob: float = 0.1,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            population_size=population_size,
            exploit_quantile=exploit_quantile,
            min_cohort=min_cohort,
            perturb_scale=perturb_scale,
            resample_prob=resample_prob,
            **config,
        )
        fid = space.fidelity
        assert fid is not None
        self.fidelity_name = fid.name
        self.population_size = int(population_size)
        if self.population_size < 2:
            raise ValueError("population_size must be >= 2")
        self.exploit_quantile = float(exploit_quantile)
        if not 0.0 < self.exploit_quantile <= 0.5:
            raise ValueError("exploit_quantile must be in (0, 0.5]")
        self.min_cohort = max(2, int(min_cohort))
        self.perturb_scale = float(perturb_scale)
        self.resample_prob = float(resample_prob)
        self.budgets = space.fidelity.rungs()
        self.cube = UnitCube(space)

        #: rung index -> lineage -> (objective, params, trial_id)
        self._rungs: List[Dict[str, Tuple[float, Dict[str, Any], str]]] = [
            {} for _ in self.budgets
        ]
        #: (lineage, budget) pairs already issued — ASHA-style dedup
        self._issued: Set[Tuple[str, int]] = set()
        #: trial ids whose continuation has been issued
        self._continued: Set[str] = set()
        #: number of base-rung members seeded so far
        self._seeded = 0

    def _rung_index(self, budget: int) -> Optional[int]:
        for i, b in enumerate(self.budgets):
            if b == budget:
                return i
        return None

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        budget = int(trial.params[self.fidelity_name])
        ri = self._rung_index(budget)
        if ri is None:
            # off-ladder budget (manual insert): absorb at nearest rung below
            below = [i for i, b in enumerate(self.budgets) if b <= budget]
            if not below:
                return
            ri = below[-1]
        lineage = trial.lineage or self.space.hash_point(trial.params)
        self._issued.add((lineage, self.budgets[ri]))
        cur = self._rungs[ri].get(lineage)
        obj = float(trial.objective)
        if cur is None or obj < cur[0]:
            self._rungs[ri][lineage] = (obj, dict(trial.params), trial.id)
        if ri == 0:
            # replay-recovery: a rebuilt instance must not re-seed members it
            # already has results for
            self._seeded = max(self._seeded, len(self._rungs[0]))

    # -- suggest -----------------------------------------------------------
    @property
    def cohort_size(self):
        # the population trains rung-by-rung: one same-budget pool
        return self.population_size

    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for _ in range(num):
            pt = self._suggest_one()
            if pt is None:
                break
            out.append(pt)
        return out

    def _suggest_one(self) -> Optional[Dict[str, Any]]:
        # 1. continue any finished member that hasn't been continued yet,
        #    lowest rungs first so the population keeps moving together-ish
        for ri in range(len(self.budgets) - 1):
            cohort = self._rungs[ri]
            for lineage, (obj, params, tid) in sorted(
                cohort.items(), key=lambda kv: kv[1][0]
            ):
                if tid in self._continued:
                    continue
                pt, parent = self._continue(ri, lineage, obj, params, tid)
                next_budget = self.budgets[ri + 1]
                new_lineage = self.space.hash_point(
                    {k: v for k, v in pt.items() if k != "_parent"}
                )
                if (new_lineage, next_budget) in self._issued:
                    # identical continuation already in flight (replay); just
                    # mark and move on
                    self._continued.add(tid)
                    continue
                self._continued.add(tid)
                self._issued.add((new_lineage, next_budget))
                return pt
        # 2. seed the base rung until the population is full
        if self._seeded < self.population_size:
            base = self.budgets[0]
            for _ in range(100):
                pt = self.space.sample(1, seed=self.rng)[0]
                pt[self.fidelity_name] = base
                lineage = self.space.hash_point(pt)
                if (lineage, base) not in self._issued:
                    self._issued.add((lineage, base))
                    self._seeded += 1
                    return pt
        return None  # everyone in flight or at the top rung

    def _continue(
        self,
        ri: int,
        lineage: str,
        obj: float,
        params: Dict[str, Any],
        tid: str,
    ) -> Tuple[Dict[str, Any], str]:
        """Build the (ri+1)-rung continuation for one member."""
        cohort = self._rungs[ri]
        next_budget = self.budgets[ri + 1]
        new_params = dict(params)
        parent = tid
        if len(cohort) >= self.min_cohort:
            ranked = sorted(cohort.items(), key=lambda kv: kv[1][0])
            k = max(1, int(len(ranked) * self.exploit_quantile))
            bottom = {ln for ln, _ in ranked[-k:]}
            if lineage in bottom:
                # deterministic per source trial: a rebuilt instance (replay
                # after a restart) or a concurrent producer must
                # regenerate the IDENTICAL continuation so ledger dedup can
                # absorb it — so derive the donor choice and the explore
                # perturbation from the trial id, not from shared RNG state.
                # blake2b, not hash(): str hashes are salted per interpreter
                # (PYTHONHASHSEED), which would break exactly the
                # cross-process replay this seed exists for
                rng = np.random.default_rng(_exploit_seed(tid))
                donor_lineage, (d_obj, d_params, d_tid) = ranked[
                    int(rng.integers(k))
                ]
                if donor_lineage != lineage:
                    new_params = self._explore(dict(d_params), rng)
                    parent = d_tid
                    log.debug(
                        "pbt: %s exploits %s at rung %d (%.4g -> %.4g)",
                        lineage[:8], donor_lineage[:8], ri, obj, d_obj,
                    )
        new_params[self.fidelity_name] = next_budget
        new_params["_parent"] = parent
        return new_params, parent

    def _explore(self, params: Dict[str, Any], rng) -> Dict[str, Any]:
        fid_value = params.pop(self.fidelity_name, None)
        params.pop("_parent", None)
        vec = self.cube.transform(params)
        for j in range(self.cube.n_dims):
            if self.cube.categorical_mask[j] or rng.random() < self.resample_prob:
                vec[j] = rng.random()
            else:
                vec[j] = float(np.clip(
                    vec[j] + rng.normal(0, self.perturb_scale),
                    1e-6, 1 - 1e-6,
                ))
        out = self.cube.untransform(vec)
        if fid_value is not None:
            out[self.fidelity_name] = fid_value
        return out

    # -- completion ---------------------------------------------------------
    @property
    def is_done(self) -> bool:
        return len(self._rungs[-1]) >= self.population_size

    # -- introspection ------------------------------------------------------
    @property
    def rung_table(self) -> List[Dict[str, Any]]:
        return [
            {"bracket": 0, "budget": b, "n": len(r), "promoted":
             sum(1 for (_, _, tid) in r.values() if tid in self._continued)}
            for b, r in zip(self.budgets, self._rungs)
        ]

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        s = super().state_dict()
        s["rungs"] = [
            {k: [v[0], v[1], v[2]] for k, v in r.items()} for r in self._rungs
        ]
        s["issued"] = sorted(list(t) for t in self._issued)
        s["continued"] = sorted(self._continued)
        s["seeded"] = self._seeded
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        rungs = state.get("rungs")
        if rungs is not None:
            self._rungs = [
                {k: (float(v[0]), dict(v[1]), str(v[2])) for k, v in r.items()}
                for r in rungs
            ]
            while len(self._rungs) < len(self.budgets):
                self._rungs.append({})
        self._issued = {tuple(t) for t in state.get("issued", [])}
        self._continued = set(state.get("continued", []))
        self._seeded = int(state.get("seeded", 0))
