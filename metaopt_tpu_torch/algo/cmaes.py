"""CMA-ES — covariance matrix adaptation evolution strategy.

Port of ``metaopt_tpu/algo/cmaes.py``, unchanged: standard (μ/μ_w, λ)
CMA-ES (Hansen's tutorial formulation) run in the UnitCube, on the
asynchronous ledger model — a generation of λ candidates is issued,
``suggest`` returns nothing once the generation is fully assigned (the
worker backs off), and the (mean, σ, C, paths) update fires when all λ
results are observed.

Candidates for generation g are drawn from an RNG seeded by
``(ctor seed, g)``, so a rebuilt instance (a restarted worker replaying
the ledger) issues the IDENTICAL generation and ledger dedup absorbs the
replays. The d×d covariance math is host numpy (d is the number of
hyperparameters). The generation math runs on the shared suggest-ahead
thread (:class:`~metaopt_tpu_torch.algo.base.SuggestAhead`) under one
lock; it draws only from the per-generation RNG, so whether the thread or
the caller runs it, the draws come in the same order. Out-of-cube draws
are clipped.

Config: ``population_size`` (λ; default 4+⌊3 ln d⌋), ``sigma0``,
``max_generations``, ``suggest_prefetch_depth``, ``seed``.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, List, Optional, Set

import numpy as np

from metaopt_tpu_torch.algo.base import BaseAlgorithm, SuggestAhead, algo_registry
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space, UnitCube

log = logging.getLogger(__name__)


@algo_registry.register("cmaes")
@algo_registry.register("cma")
class CMAES(SuggestAhead, BaseAlgorithm):
    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        population_size: Optional[int] = None,
        sigma0: float = 0.3,
        max_generations: Optional[int] = None,
        suggest_prefetch_depth: int = 1,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            population_size=population_size,
            sigma0=sigma0,
            max_generations=max_generations,
            suggest_prefetch_depth=suggest_prefetch_depth,
            **config,
        )
        self.cube = UnitCube(space)
        d = self.cube.n_dims
        self.lam = int(population_size or (4 + math.floor(3 * math.log(d))))
        self.lam = max(self.lam, 4)
        self.mu = self.lam // 2
        self.sigma0 = float(sigma0)
        self.max_generations = max_generations

        # selection weights and adaptation constants (Hansen's defaults)
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / float(np.sum(self.w ** 2))
        self.c_sigma = (self.mu_eff + 2) / (d + self.mu_eff + 5)
        self.d_sigma = (
            1
            + 2 * max(0.0, math.sqrt((self.mu_eff - 1) / (d + 1)) - 1)
            + self.c_sigma
        )
        self.c_c = (4 + self.mu_eff / d) / (d + 4 + 2 * self.mu_eff / d)
        self.c_1 = 2 / ((d + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(
            1 - self.c_1,
            2 * (self.mu_eff - 2 + 1 / self.mu_eff)
            / ((d + 2) ** 2 + self.mu_eff),
        )
        #: E||N(0,I)|| for the step-size rule
        self.chi_d = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

        # distribution state
        self._mean = np.full(d, 0.5)
        self._sigma = self.sigma0
        self._C = np.eye(d)
        self._p_sigma = np.zeros(d)
        self._p_c = np.zeros(d)
        self.generation = 0
        #: per-generation replay-stable candidate seed
        self._sample_seed = int(self.rng.integers(0, 2**31 - 1))

        # async cohort bookkeeping (EvolutionES pattern)
        self._candidates: List[Dict[str, Any]] = []   # current gen, in order
        self._cand_vecs: List[np.ndarray] = []        # matching cube vectors
        self._issued = 0
        self._assigned: Set[str] = set()
        self._results: Dict[str, float] = {}          # lineage -> objective
        # suggest-ahead: the "kernel" here is the host-side generation
        # math (eigendecomposition + λ draws + CMA update), deterministic
        # from the observed results — precomputing it off the produce path
        # cannot change the issued stream. One lock guards ALL mutable
        # state; held only across host math, never across anything slow.
        self._kernel_lock = threading.RLock()
        self._last_prepare_worked = False
        self._init_suggest_ahead(suggest_prefetch_depth)

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        lineage = trial.lineage or self.space.hash_point(trial.params)
        obj = float(trial.objective)
        cur = self._results.get(lineage)
        if cur is None or obj < cur:
            self._results[lineage] = obj
        self._assigned.add(lineage)  # absorb strays (replay/insert)

    def observe(self, trials) -> None:
        with self._kernel_lock:
            super().observe(trials)
        # the batch may have completed the cohort: advance the generation
        # and draw the next λ candidates before the worker asks
        self._suggest_ahead_async()

    # -- suggest -----------------------------------------------------------
    @property
    def cohort_size(self):
        # λ candidates per generation, all at full fidelity
        return self.lam

    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        with self._kernel_lock:
            out: List[Dict[str, Any]] = []
            first = True
            for _ in range(num):
                pt = self._suggest_one()
                if first:
                    # a hit = the generation math was already done when
                    # the ask arrived (the background prepare ran)
                    (self._record_pool_miss if self._last_prepare_worked
                     else self._record_pool_hit)()
                    first = False
                if pt is None:
                    break  # generation barrier: wait for the cohort
                out.append(pt)
            return out

    def _suggest_ahead_work(self) -> None:
        with self._kernel_lock:
            self._prepare()

    def telemetry(self) -> Dict[str, int]:
        """Suggest-ahead counters (no device traffic here)."""
        return dict(self.suggest_ahead_telemetry())

    def _gen_candidates(self) -> None:
        """Draw generation ``self.generation``'s λ candidates (replay-stable)."""
        d = self.cube.n_dims
        rng = np.random.default_rng([self._sample_seed, self.generation])
        vals, vecs = np.linalg.eigh(self._C)
        root = vecs @ np.diag(np.sqrt(np.maximum(vals, 1e-20))) @ vecs.T
        self._candidates = []
        self._cand_vecs = []
        fid = self.space.fidelity
        for _ in range(self.lam):
            z = rng.standard_normal(d)
            x = np.clip(self._mean + self._sigma * (root @ z),
                        1e-6, 1 - 1e-6)
            pt = self.cube.untransform(x)
            if fid is not None:
                pt[fid.name] = fid.high
            self._candidates.append(pt)
            self._cand_vecs.append(x)
        self._issued = 0

    def _prepare(self) -> bool:
        """Advance/materialize until the current cohort can issue.

        The deterministic half of ``_suggest_one``, shared with the
        suggest-ahead thread: advance fully-observed generations, draw the
        next cohort, stop when there are candidates to issue (True) or
        suggesting is pointless (False: max generations, or the catch-up
        cap). Caller holds ``_kernel_lock``. Sets ``_last_prepare_worked``
        when any generation math ran — the prefetch-hit telemetry.

        Catch-up loop rationale: a rebuilt instance replaying N completed
        generations must fast-forward through ALL of them in one call,
        not burn one idle produce cycle per generation. Bounded: a
        σ-collapsed distribution can keep hashing onto already-evaluated
        lineages, and that must not spin forever.
        """
        worked = False
        try:
            for _ in range(256):
                cohort = {self.space.hash_point(p) for p in self._candidates}
                if cohort and cohort <= set(self._results):
                    self._advance_generation()
                    worked = True
                    continue
                if (self.max_generations is not None
                        and self.generation >= self.max_generations):
                    return False
                if not self._candidates:
                    self._gen_candidates()
                    worked = True
                    continue  # the fresh cohort may itself be fully observed
                return True
            return False  # catch-up cap hit (σ-collapse); let is_done decide
        finally:
            self._last_prepare_worked = worked

    def _suggest_one(self) -> Optional[Dict[str, Any]]:
        if not self._prepare():
            return None
        while self._issued < len(self._candidates):
            pt = self._candidates[self._issued]
            self._issued += 1
            lineage = self.space.hash_point(pt)
            if lineage not in self._assigned:
                self._assigned.add(lineage)
                return dict(pt)
        return None  # cohort fully issued; waiting on results

    def _advance_generation(self) -> None:
        d = self.cube.n_dims
        scored = sorted(
            (self._results[self.space.hash_point(p)], i)
            for i, p in enumerate(self._candidates)
        )
        elite = [self._cand_vecs[i] for _, i in scored[: self.mu]]
        old_mean = self._mean
        y = (np.stack(elite) - old_mean[None, :]) / self._sigma  # (mu, d)
        y_w = self.w @ y                                          # (d,)
        self._mean = old_mean + self._sigma * y_w

        # step-size path (C^{-1/2} via the eigh of the CURRENT C)
        vals, vecs = np.linalg.eigh(self._C)
        inv_root = vecs @ np.diag(
            1.0 / np.sqrt(np.maximum(vals, 1e-20))
        ) @ vecs.T
        self._p_sigma = (
            (1 - self.c_sigma) * self._p_sigma
            + math.sqrt(self.c_sigma * (2 - self.c_sigma) * self.mu_eff)
            * (inv_root @ y_w)
        )
        h_sigma = float(
            np.linalg.norm(self._p_sigma)
            / math.sqrt(1 - (1 - self.c_sigma) ** (2 * (self.generation + 1)))
            < (1.4 + 2 / (d + 1)) * self.chi_d
        )
        self._p_c = (
            (1 - self.c_c) * self._p_c
            + h_sigma
            * math.sqrt(self.c_c * (2 - self.c_c) * self.mu_eff) * y_w
        )
        rank1 = np.outer(self._p_c, self._p_c)
        rank_mu = (y * self.w[:, None]).T @ y
        self._C = (
            (1 - self.c_1 - self.c_mu) * self._C
            + self.c_1 * (
                rank1
                + (1 - h_sigma) * self.c_c * (2 - self.c_c) * self._C
            )
            + self.c_mu * rank_mu
        )
        self._sigma *= math.exp(
            (self.c_sigma / self.d_sigma)
            * (np.linalg.norm(self._p_sigma) / self.chi_d - 1)
        )
        self._sigma = float(np.clip(self._sigma, 1e-8, 1.0))
        self.generation += 1
        self._candidates = []
        self._cand_vecs = []
        self._issued = 0
        log.debug("cmaes generation %d: sigma=%.4g mean=%s",
                  self.generation, self._sigma, np.round(self._mean, 3))

    @property
    def is_done(self) -> bool:
        if (self.max_generations is not None
                and self.generation >= self.max_generations):
            return True
        return super().is_done

    def seed_rng(self, seed: Optional[int]) -> None:
        super().seed_rng(seed)
        # getattr: callable from the base ctor before the lock exists
        with getattr(self, "_kernel_lock", threading.RLock()):
            self._sample_seed = int(self.rng.integers(0, 2**31 - 1))

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        with self._kernel_lock:
            return self._state_dict_locked()

    def _state_dict_locked(self) -> Dict[str, Any]:
        s = super().state_dict()
        s.update(
            mean=self._mean.tolist(),
            sigma=self._sigma,
            C=self._C.tolist(),
            p_sigma=self._p_sigma.tolist(),
            p_c=self._p_c.tolist(),
            generation=self.generation,
            sample_seed=self._sample_seed,
            issued=self._issued,
            assigned=sorted(self._assigned),
            results=dict(self._results),
        )
        return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with self._kernel_lock:
            self._load_state_dict_locked(state)

    def _load_state_dict_locked(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        if "mean" in state:
            self._mean = np.asarray(state["mean"], float)
            self._sigma = float(state["sigma"])
            self._C = np.asarray(state["C"], float)
            self._p_sigma = np.asarray(state["p_sigma"], float)
            self._p_c = np.asarray(state["p_c"], float)
            self.generation = int(state["generation"])
            self._sample_seed = int(state["sample_seed"])
            self._candidates = []
            self._cand_vecs = []
            if self.generation < (self.max_generations or float("inf")):
                self._gen_candidates()
            self._issued = int(state.get("issued", 0))
            self._assigned = set(state.get("assigned", []))
            self._results = dict(state.get("results", {}))
