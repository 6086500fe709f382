"""GP-EI Bayesian optimization (port of ``metaopt_tpu/algo/gp_bo.py``).

A Gaussian-process surrogate (ARD RBF kernel, exact marginal likelihood)
and Expected Improvement over a candidate set, on the algorithm's device
(``cuda`` unless the caller passes ``device``; without CUDA the
constructor raises). The reference compiles each stage into an XLA
program; here each is eager PyTorch on the observation buffer's device:

- observations live in the pow2-padded :class:`ObservationBuffer`;
  padding is masked out of the kernel matrix as unit-diagonal rows, which
  contribute zero to the marginal likelihood's data term and log-det;
- hyperparameters (ARD lengthscales, amplitude, noise) are fit by
  ``fit_iters`` Adam steps on the exact negative log marginal likelihood,
  an eager loop of forward and autograd backward passes. Adam is written
  out in optax's order (moments, bias correction, ``-lr·m̂/(√v̂ + 1e-8)``),
  not ``torch.optim``, whose import pulls in ``torch._dynamo``;
- acquisition is EI over uniform draws plus Gaussian perturbations of the
  incumbent, the top ``n_out`` per pool by a stable descending sort (the
  reference's ``top_k`` puts the lower index first on ties).

The device work never waits on the host: a Cholesky factor comes from
``torch.linalg.cholesky_ex`` and a failed one becomes NaNs by
``torch.where``, as ``jnp.linalg.cholesky`` returns them, so no launch
syncs to check it. The products of the gram, the kernel row and the
posterior mean are elementwise sums, so a process-wide TF32 switch cannot
lower them below f32. The one read per refit is the warm refit's
``drift`` (a scalar), as in the reference; an acquisition reads back its
winners only.

Incremental fast path (default), as in the reference: the device keeps a
Cholesky factor of the masked gram beside the buffer
(:class:`CholeskyFactor`) and extends it by one O(n²) triangular-solve
row per append; hyperparameters are warm-started with ``refit_iters``
Adam steps and re-anchored by a full factorization every
``reanchor_every`` appends, or at once when the warm refit's drift
exceeds ``drift_threshold``. ``incremental=False`` refits cold on every
launch.

Random draws: the candidate draws of a launch come from one generator per
pool, seeded by (kernel seed, observation count, pool index)
(:func:`gp_pool_draws`), as the reference keys its threefry draws; the
functions take them through a ``draws`` argument, so a test can feed the
reference's own candidates. Philox (``cuda``) and mt19937 (CPU) draw
different streams, and neither is threefry.

Config surface and defaults are the reference's: ``n_initial_points``,
``n_candidates``, ``fit_iters``, ``fit_lr``, ``pool_prefetch``,
``parallel_strategy``, ``incremental``, ``reanchor_every``,
``refit_iters``, ``drift_threshold``, ``suggest_prefetch_depth``,
``transfer_max_prior``, ``seed``; ``device`` is the port's own and is kept
out of ``configuration``. Not ported yet: the fleet path
(``gp_acquire_fleet``, ``fuse_snapshot`` / ``fuse_commit`` /
``fuse_abort``), and the analysis helpers ``partial_dependence`` and
``ard_importance`` with their fits.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metaopt_tpu_torch.algo.base import BaseAlgorithm, SuggestAhead, algo_registry
from metaopt_tpu_torch.algo.obs_buffer import (
    CholeskyFactor,
    ObservationBuffer,
    _chol_grow,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ops.tpe_math import _splitmix64, pad_pow2, stream_seed
from metaopt_tpu_torch.space import Space, UnitCube
from metaopt_tpu_torch.utils.device import resolve_device

_JITTER = 1e-6
# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _kernel(x1, x2, log_ls, log_amp):
    """ARD RBF: amp·exp(−½ Σ_d (Δ_d / ls_d)²);  x1 (N,d), x2 (M,d).

    The reference's expansion ‖z1‖² + ‖z2‖² − 2·z1·z2ᵀ, with the cross
    term summed elementwise (never a TF32 matrix product)."""
    ls = torch.exp(log_ls)
    z1 = x1 / ls[None, :]
    z2 = x2 / ls[None, :]
    cross = torch.sum(z1[:, None, :] * z2[None, :, :], dim=-1)
    d2 = (torch.sum(z1 * z1, -1)[:, None] + torch.sum(z2 * z2, -1)[None, :]
          - 2.0 * cross)
    return torch.exp(log_amp) * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def _masked_gram(X, mask, log_ls, log_amp, log_noise):
    """Kernel matrix with padding rows replaced by unit diagonal.

    Padded entries contribute log(1)=0 to the log-det and 0 to the data
    term (their y is 0 and their cross-covariance is 0), so the marginal
    likelihood of the REAL observations is exact at any padded size.
    """
    n = X.shape[0]
    K = _kernel(X, X, log_ls, log_amp)
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    noise = torch.exp(log_noise) + _JITTER
    return mm * K + eye * torch.where(mask > 0, noise, 1.0)


def _cholesky(K):
    """Lower Cholesky factor; all NaN where ``K`` is not positive definite
    (``jnp.linalg.cholesky``'s answer), decided on the device."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info == 0, L, torch.nan)


def _cho_solve(L, b):
    """``cho_solve((L, True), b)`` for a vector or a matrix ``b``."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def _neg_mll(params, X, y, mask):
    K = _masked_gram(X, mask, params["log_ls"], params["log_amp"],
                     params["log_noise"])
    L = _cholesky(K)
    ym = y * mask
    alpha = _cho_solve(L, ym)
    data = 0.5 * torch.sum(ym * alpha)
    logdet = torch.sum(torch.log(torch.clamp(torch.diagonal(L), min=1e-30)))
    return data + logdet


def _default_params(d: int, device) -> Dict[str, torch.Tensor]:
    """Cold-start hyperparameters (the values the cold fit starts from)."""
    return {
        "log_ls": torch.full((d,), float(np.log(np.float32(0.3))), dtype=torch.float32,
                             device=device),
        "log_amp": torch.zeros((), dtype=torch.float32, device=device),
        # a fill, not torch.tensor(value, device=...): that copy from the
        # host would wait for the device
        "log_noise": torch.full((), float(np.log(np.float32(1e-2))), dtype=torch.float32,
                                device=device),
    }


def _pack(params) -> torch.Tensor:
    return torch.cat([params["log_ls"].reshape(-1), params["log_amp"].reshape(1),
                      params["log_noise"].reshape(1)])


def _unpack(theta) -> Dict[str, torch.Tensor]:
    return {"log_ls": theta[:-2], "log_amp": theta[-2], "log_noise": theta[-1]}


def _live(X, y_raw, n: int):
    """(mask, live) of the rows [0, n) with a finite objective."""
    idx = torch.arange(X.shape[0], device=X.device)
    live = (idx < n) & torch.isfinite(y_raw)
    return live.to(torch.float32), live


def _adam_fit(theta, X, y, mask, fit_lr: float, fit_iters: int):
    """``fit_iters`` steps of optax.adam(fit_lr) on the flat parameter
    vector ``theta`` (log_ls..., log_amp, log_noise); eps_root 0."""
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    lr = float(np.float32(fit_lr))
    for count in range(1, fit_iters + 1):
        with torch.enable_grad():
            t = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(_neg_mll(_unpack(t), X, y, mask), t)
        with torch.no_grad():
            mu = (1.0 - _B1) * g + _B1 * mu
            nu = (1.0 - _B2) * (g * g) + _B2 * nu
            bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
            bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            theta = theta + (-lr) * upd
    return theta.detach()


def gp_fit_mll(X, y_raw, n: int, mu: float, sd: float, init_params, fit_lr: float, *,
               fit_iters: int):
    """Adam-on-exact-MLL fit from ``init_params``; returns (params, drift).

    ``drift`` (a device scalar) is the max absolute parameter movement over
    the fit — the host reads it to decide whether a short warm refit was
    enough or the data shifted under the surrogate and a full-trip refit is
    due.
    """
    mask, live = _live(X, y_raw, n)
    y = torch.where(live, (y_raw - mu) / sd, 0.0)
    theta0 = _pack(init_params).to(torch.float32)
    theta = _adam_fit(theta0, X, y, mask, fit_lr, fit_iters)
    drift = torch.max(torch.abs(theta - theta0))
    return _unpack(theta), drift


def gp_chol_full(X, y_raw, n: int, params):
    """Full Cholesky of the masked gram — the re-anchor factorization."""
    mask, _ = _live(X, y_raw, n)
    K = _masked_gram(X, mask, params["log_ls"], params["log_amp"],
                     params["log_noise"])
    return _cholesky(K)


def gp_chol_append(L, X, y_raw, i: int, params):
    """Extend the factor through observation row ``i``: O(n²), not O(n³).

    For K' = [[K, k], [kᵀ, κ]] the new factor row is (z, λ) with
    z = L⁻¹k (one triangular solve) and λ = √(κ − zᵀz). Rows ≥ i are unit
    rows, so their forward-substitution entries are exactly 0 and the row
    lands as (z, λ, 0, …). A dead row (non-finite objective) gets k = 0,
    κ = 1: the unit row e_i the full factorization would produce. Returns
    a new tensor; ``L`` is left as it was.
    """
    idx = torch.arange(X.shape[0], device=X.device)
    prev = ((idx < i) & torch.isfinite(y_raw)).to(torch.float32)
    fin = torch.isfinite(y_raw[i])
    k = _kernel(X, X[i][None, :], params["log_ls"], params["log_amp"])[:, 0]
    k = k * prev * fin.to(torch.float32)
    kappa = torch.where(
        fin,
        torch.exp(params["log_amp"]) + torch.exp(params["log_noise"]) + _JITTER,
        1.0,
    )
    z = torch.linalg.solve_triangular(L, k[:, None], upper=False)[:, 0]
    lam = torch.sqrt(torch.clamp(kappa - torch.sum(z * z), min=_JITTER))
    out = L.clone()
    out[i, :] = z
    out[i, i] = lam
    return out


def gp_pool_draws(fit_seed: int, pool: int, n_cand: int, d: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniforms (n_cand // 2, d), normals (n_cand - n_cand // 2, d)) of one
    pool, from a generator of ``device`` seeded by (fit seed, pool) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_splitmix64(fit_seed ^ _splitmix64(int(pool))) >> 1)
    u = torch.rand((n_cand // 2, d), generator=gen, device=device)
    z = torch.randn((n_cand - n_cand // 2, d), generator=gen, device=device)
    return u, z


def _row(X, idx):
    """``X[idx]`` for a 0-d index tensor, without reading it on the host
    (indexing by a 0-d tensor converts it to a Python int: a device sync)."""
    return X[idx.reshape(1)][0]


def _candidates(incumbent, draws):
    u, z = draws
    cand_p = torch.clamp(incumbent[None, :] + 0.1 * z, 1e-6, 1 - 1e-6)
    return torch.cat([u, cand_p], 0)


def _expected_improvement(X, mask, L, alpha, best_y, cand, params):
    """EI for MINIMIZATION, E[max(best_y − f, 0)], at each row of ``cand``."""
    Ks = _kernel(X, cand, params["log_ls"], params["log_amp"]) * mask[:, None]
    mu_q = torch.sum(Ks * alpha[:, None], dim=0)
    w = _cho_solve(L, Ks)
    var = torch.exp(params["log_amp"]) - torch.sum(Ks * w, dim=0)
    sigma = torch.sqrt(torch.clamp(var, min=1e-12))
    gamma = (best_y - mu_q) / sigma
    pdf = torch.exp(-0.5 * gamma * gamma) * _INV_SQRT_2PI
    return sigma * (gamma * torch.special.ndtr(gamma) + pdf)


def _top(ei, n_out: int):
    """Indices of the ``n_out`` largest entries along the last axis, the
    lower index first on ties (``jax.lax.top_k``'s order)."""
    return torch.sort(ei, dim=-1, descending=True, stable=True).indices[..., :n_out]


def gp_suggest_fused(X, y_raw, n: int, mu: float, sd: float, fit_seed: int, fit_lr: float, *,
                     fit_iters: int, n_cand: int, n_out: int,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The cold path: fit from the default hyperparameters, factor, and EI
    top-``n_out`` over one pool of ``n_cand`` candidates.

    The live mask and the standardized targets derive from the raw buffer
    (``idx < n`` and finiteness): a diverged trial's NaN/inf objective
    drops out of the mask entirely. ``draws`` (uniforms, normals) replaces
    the pool's generated draws.
    """
    d = X.shape[1]
    mask, live = _live(X, y_raw, n)
    y = torch.where(live, (y_raw - mu) / sd, 0.0)
    best_y = torch.min(torch.where(live, y, torch.inf))
    theta = _adam_fit(_pack(_default_params(d, X.device)), X, y, mask, fit_lr, fit_iters)
    params = _unpack(theta)
    K = _masked_gram(X, mask, params["log_ls"], params["log_amp"], params["log_noise"])
    L = _cholesky(K)
    alpha = _cho_solve(L, y * mask)
    incumbent = _row(X, torch.argmin(torch.where(mask > 0, y, torch.inf)))
    if draws is None:
        draws = gp_pool_draws(fit_seed, 0, n_cand, d, X.device)
    cand = _candidates(incumbent, draws)
    ei = _expected_improvement(X, mask, L, alpha, best_y, cand, params)
    return cand[_top(ei, n_out)]


def _gp_acquire_body(X, y_raw, L, n: int, mu: float, sd: float,
                     draws: Sequence[Tuple[torch.Tensor, torch.Tensor]], params, *,
                     n_cand: int, n_out: int):
    """EI top-``n_out`` over ``len(draws)`` candidate pools in one call.

    The surrogate fit is an INPUT here (resident factor + params), so the
    steady-state suggest pays one O(n²·c) acquisition instead of the O(n³)
    fit+factor+acquire. Returns (len(draws) * n_out, d).
    """
    d = X.shape[1]
    mask, live = _live(X, y_raw, n)
    y = torch.where(live, (y_raw - mu) / sd, 0.0)
    masked_y = torch.where(live, y, torch.inf)
    best_y = torch.min(masked_y)
    alpha = _cho_solve(L, y * mask)
    incumbent = _row(X, torch.argmin(masked_y))
    n_pools = len(draws)
    cand = torch.stack([_candidates(incumbent, dr) for dr in draws])   # (P, C, d)
    ei = _expected_improvement(X, mask, L, alpha, best_y,
                               cand.reshape(n_pools * n_cand, d), params)
    top = _top(ei.reshape(n_pools, n_cand), n_out)                     # (P, n_out)
    picked = torch.gather(cand, 1, top[:, :, None].expand(n_pools, n_out, d))
    return picked.reshape(n_pools * n_out, d)


def gp_acquire_fused(X, y_raw, L, n: int, mu: float, sd: float, fit_seed: int, count: int,
                     params, *, n_cand: int, n_out: int, n_pools: int,
                     draws: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
    """Acquisition over ``n_pools`` pools; pool p draws from
    ``gp_pool_draws(fit_seed, count + p, ...)``, exactly the stream p
    sequential single-pool calls would use. ``draws``, when given,
    replaces the generated draws (one (uniforms, normals) pair per pool)."""
    if draws is None:
        d = X.shape[1]
        draws = [gp_pool_draws(fit_seed, count + p, n_cand, d, X.device)
                 for p in range(n_pools)]
    return _gp_acquire_body(X, y_raw, L, n, mu, sd, draws, params,
                            n_cand=n_cand, n_out=n_out)


@algo_registry.register("gp")
class GPBO(SuggestAhead, BaseAlgorithm):
    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        n_initial_points: int = 10,
        n_candidates: int = 512,
        fit_iters: int = 60,
        fit_lr: float = 0.05,
        pool_prefetch: int = 4,
        parallel_strategy: Optional[str] = None,
        incremental: bool = True,
        reanchor_every: int = 16,
        refit_iters: int = 15,
        drift_threshold: float = 0.25,
        suggest_prefetch_depth: int = 1,
        transfer_max_prior: int = 32,
        device=None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            n_initial_points=n_initial_points,
            n_candidates=n_candidates,
            fit_iters=fit_iters,
            fit_lr=fit_lr,
            pool_prefetch=pool_prefetch,
            parallel_strategy=parallel_strategy,
            incremental=incremental,
            reanchor_every=reanchor_every,
            refit_iters=refit_iters,
            drift_threshold=drift_threshold,
            suggest_prefetch_depth=suggest_prefetch_depth,
            transfer_max_prior=transfer_max_prior,
            **config,
        )
        self.device = resolve_device(device)
        self.n_initial_points = n_initial_points
        self.n_candidates = n_candidates
        self.fit_iters = fit_iters
        self.fit_lr = fit_lr
        self.pool_prefetch = max(1, int(pool_prefetch))
        # incremental-Cholesky fast path knobs (module docstring)
        self.incremental = bool(incremental)
        self.reanchor_every = max(1, int(reanchor_every))
        self.refit_iters = max(1, int(refit_iters))
        self.drift_threshold = float(drift_threshold)
        # the classic async-GP "constant liar": pending points join the
        # fit with a lie objective (mean = CL-mean, max = CL-max)
        if parallel_strategy not in (None, "none", "mean", "max"):
            raise ValueError(
                f"parallel_strategy must be one of none|mean|max, "
                f"got {parallel_strategy!r}"
            )
        self.parallel_strategy = (
            None if parallel_strategy in (None, "none") else parallel_strategy
        )
        self.supports_pending = self.parallel_strategy is not None
        self.cube = UnitCube(space)
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._buf = ObservationBuffer(self.cube.n_dims, self.device)
        # the resident factor + fitted hyperparameters. Mutated ONLY under
        # _launch_lock (factor maintenance reads the drift back from the
        # device, which the kernel lock must never cover); _params_host is
        # the float64 snapshot state_dict serializes (exact float32 round
        # trip), read from the device only when a state_dict asks
        self._factor = CholeskyFactor()
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._params_host: Optional[Dict[str, Any]] = None
        self._restore_trace: Optional[Dict[str, Any]] = None
        self._aug_key = None   # (n, pending_fp, factor version) of _aug
        self._aug: Optional[Tuple] = None
        self._launches = 0
        self._pending_X: List[np.ndarray] = []   # lie rows, ephemeral
        self._pending_fp: tuple = ()
        self._kernel_seed = int(self.rng.integers(0, 2**31 - 1))
        # pooled suggestions from the last launch, valid while the fit
        # (observation count) is unchanged; (_pool_n, _pool_idx) key the
        # draw stream: a re-launch at the same fit MUST draw fresh
        # candidates, not re-serve the points it already issued
        self._prefetch: List[Dict[str, Any]] = []
        self._prefetch_n_obs = -1
        self._pool_n = -1
        self._pool_idx = 0
        # TPE's locking: _kernel_lock guards host state (lists, stream
        # position, prefetch, pending) and is held only for snapshots and
        # commits; _launch_lock serializes launch+readback AND every
        # factor mutation. Lock order is ALWAYS launch → kernel.
        self._kernel_lock = threading.RLock()
        self._launch_lock = threading.RLock()
        self._ei_active = False
        self._init_suggest_ahead(suggest_prefetch_depth)
        # transfer warm-start: the factor is O(n³) in resident rows, so a
        # large ancestor history is subsampled to its best points
        self.transfer_max_prior = max(0, int(transfer_max_prior))

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        # float32 from the start: serialized state must round-trip
        # bit-identically
        self._X.append(np.asarray(
            self.cube.transform(trial.params), np.float32))
        self._y.append(float(trial.objective))

    def observe_prior(self, trials) -> None:
        """Seed from an ancestor, keeping only its ``transfer_max_prior``
        best points (every extra gram row costs cubic work, and a GP has
        no per-row weight to discount)."""
        ranked = sorted(
            (t for t in trials if t.objective is not None),
            key=lambda t: t.objective,
        )
        super().observe_prior(ranked[: self.transfer_max_prior])

    def observe(self, trials) -> None:
        with self._kernel_lock:
            super().observe(trials)
        # pending-enabled instances refill from set_pending instead (the
        # Producer calls it right after observe)
        if not self.supports_pending:
            self._suggest_ahead_async()

    def set_pending(self, trials) -> None:
        """Reserved trials become constant-liar rows for the next fit:
        ephemeral, never serialized, never counted toward ``is_done``; a
        changed pending set invalidates the prefetch pool."""
        if self.parallel_strategy is None:
            return
        with self._kernel_lock:
            live = [t for t in trials if t.id not in self._observed]
            fp = tuple(sorted(t.id for t in live))
            if fp != self._pending_fp:
                self._pending_fp = fp
                self._pending_X = [self.cube.transform(t.params) for t in live]
                self._prefetch = []
                self._prefetch_n_obs = -1
        self._suggest_ahead_async()

    # -- suggest -----------------------------------------------------------
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        with self._kernel_lock:
            if len(self._y) < self.n_initial_points:
                return [self.space.sample(1, seed=self.rng)[0]
                        for _ in range(num)]
        # EI path runs with the kernel lock RELEASED — _suggest_ei takes
        # launch → kernel (observations only grow)
        return self._suggest_ei(num)

    def _suggest_ahead_ready(self) -> bool:
        return self._ei_active and len(self._y) >= self.n_initial_points

    def _suggest_ahead_work(self) -> None:
        """Prepare the next pool(s) off the critical path (SuggestAhead):
        the launch lock is held across the refill, so a concurrent suggest()
        waits for the fresh pool instead of racing it."""
        with self._launch_lock:
            for _ in range(self.suggest_prefetch_depth):
                with self._kernel_lock:
                    floor = self.pool_prefetch * (
                        self.suggest_prefetch_depth - 1)
                    if (self._prefetch_n_obs == len(self._y)
                            and len(self._prefetch) > floor):
                        return
                    if not any(np.isfinite(v) for v in self._y):
                        return  # nothing to fit — suggest() goes uniform
                self._refill_pool()

    def _refill_pool(self, min_points: Optional[int] = None) -> None:
        """One launch appended to the prefetch (caller holds _launch_lock);
        committed only if the fit is unchanged — a stale pool is discarded,
        burning pool indices, which is safe because the stream is keyed
        (n_obs, pool_idx)."""
        with self._kernel_lock:
            fit_id = (len(self._y), self._pending_fp)
        pts = self._launch_ei(max(self.pool_prefetch, int(min_points or 0)))
        with self._kernel_lock:
            if (len(self._y), self._pending_fp) != fit_id:
                return  # computed against an outdated fit: discard
            if self._prefetch_n_obs != len(self._y):
                self._prefetch = []
                self._prefetch_n_obs = len(self._y)
            self._prefetch.extend(pts)

    def _suggest_ei(self, num: int) -> List[Dict[str, Any]]:
        served_hot = True
        with self._launch_lock:
            while True:
                with self._kernel_lock:
                    self._ei_active = True
                    if not any(np.isfinite(v) for v in self._y):
                        # every observation diverged: explore uniformly
                        return [self.space.sample(1, seed=self.rng)[0]
                                for _ in range(num)]
                    if self._prefetch_n_obs != len(self._y):
                        self._prefetch = []
                        self._prefetch_n_obs = len(self._y)
                    if len(self._prefetch) >= num:
                        out = self._prefetch[:num]
                        self._prefetch = self._prefetch[num:]
                        (self._record_pool_hit if served_hot
                         else self._record_pool_miss)()
                        return out
                    missing = num - len(self._prefetch)
                served_hot = False
                self._refill_pool(missing)

    def _launch_ei(self, num: int) -> List[Dict[str, Any]]:
        """One acquisition launch covering ``num``; returns the whole pool.

        Snapshot (buffer sync, stats, stream position) under the kernel
        lock; factor maintenance (warm refit / re-anchor / row extends)
        and the launch + readback OUTSIDE it. The caller's _launch_lock
        serializes every factor reader/writer.
        """
        with self._kernel_lock:
            self._buf.sync(self._X, self._y)
            n = len(self._y)
            y_fin = [v for v in self._y if np.isfinite(v)]
            if self._pool_n != n:
                self._pool_n, self._pool_idx = n, 0
            pool_w = pad_pow2(min(num, self.pool_prefetch), minimum=1)
            n_pools = 1
            if num > pool_w:
                n_pools = pad_pow2(-(-num // pool_w), minimum=1)
            count = self._pool_idx
            self._pool_idx += n_pools
            fit_seed = stream_seed(self._kernel_seed, n)
            pending = (list(self._pending_X)
                       if (self._pending_X
                           and self.parallel_strategy is not None
                           and n > 0)
                       else [])
            pending_fp = self._pending_fp
            # hyperparameters fit on the OBSERVATIONS only (factor and
            # params must not depend on the ephemeral pending set);
            # acquisition standardizes over finite obs + lies
            mu_o = float(np.mean(y_fin))
            sd_o = float(np.std(y_fin) + 1e-8)
            stats = list(y_fin)
            lie = None
            if pending:
                lie = (mu_o if self.parallel_strategy == "mean"
                       else float(np.max(y_fin)))
                stats += [lie] * len(pending)
            stats_arr = np.asarray(stats, np.float32)
            mu_a, sd_a = float(stats_arr.mean()), float(stats_arr.std() + 1e-8)
            self._launches += 1
        self._ensure_factor(n, mu_o, sd_o)
        Xq, yq, n_eff, L = self._buf.Xdev, self._buf.ydev, n, self._factor.L
        if pending and lie is not None and np.isfinite(lie):
            Xq, yq, n_eff, L = self._aug_factor(pending, lie, n, pending_fp)
        best = gp_acquire_fused(
            Xq, yq, L, n_eff, mu_a, sd_a, fit_seed, count, self._params,
            n_cand=pad_pow2(self.n_candidates),
            n_out=pool_w,
            n_pools=n_pools,
        ).cpu().numpy()
        fid = self.space.fidelity
        pts = []
        for row in best:
            pt = self.cube.untransform(row)
            if fid is not None:
                pt[fid.name] = fid.high
            pts.append(pt)
        return pts

    # -- incremental factor maintenance ------------------------------------
    def _ensure_factor(self, n: int, mu: float, sd: float) -> None:
        """Bring (params, factor) current through observation ``n``.

        Caller holds _launch_lock (NOT the kernel lock — the drift readback
        waits on the device). Three regimes:

        - re-anchor (cold start, ``incremental=False``, every
          ``reanchor_every`` appends, or host lists shrank): fit
          hyperparameters — warm-started with the short trip count when
          possible, escalating to the full ``fit_iters`` when the reported
          drift exceeds ``drift_threshold`` — then one full factorization;
        - steady state: grow the factor to the buffer's pow2 capacity if it
          moved, then one O(n²) triangular-solve extension per new row;
        - restore: replay the serialized trace first (bit-identical), then
          fall through to the regimes above for anything newer.
        """
        if self._restore_trace is not None:
            self._replay_restore_trace()
        f = self._factor
        Xd, yd = self._buf.Xdev, self._buf.ydev
        cap = self._buf.cap
        cold = self._params is None or f.L is None
        stale = (not self.incremental or cold or f.rows > n
                 or (n - f.anchor_n) >= self.reanchor_every)
        if not stale:
            if cap != f.cap:
                f.grow(cap)
            for i in range(f.rows, n):
                f.append_row(gp_chol_append(f.L, Xd, yd, i, self._params), i)
            return
        warm = self.incremental and not cold
        init = self._params if warm else _default_params(self.cube.n_dims, self.device)
        iters = self.refit_iters if warm else self.fit_iters
        params, drift = gp_fit_mll(Xd, yd, n, mu, sd, init, self.fit_lr,
                                   fit_iters=iters)
        if warm and float(drift) > self.drift_threshold:
            # the short warm refit moved the hyperparameters a long way:
            # the data shifted under the surrogate — pay the full trips
            params, _ = gp_fit_mll(Xd, yd, n, mu, sd, params, self.fit_lr,
                                   fit_iters=self.fit_iters)
            f.drift_refits += 1
        self._params = params
        self._params_host = None   # read back when a state_dict asks for it
        f.anchor(gp_chol_full(Xd, yd, n, params), n, cap)

    def _replay_restore_trace(self) -> None:
        """Rebuild the factor a serialized state described, bit for bit.

        An incremental factor is a PATH-dependent float product, so the
        state carries the op trace (anchor at a historical (n, cap) +
        grow/append ops) and this replays the same functions at the same
        historical shapes against SLICES of today's buffer. The masked gram
        zeroes every row the historical mask excluded, so each replayed op
        sees identical inputs and returns an identical factor.
        """
        t, self._restore_trace = self._restore_trace, None
        if not t or t.get("params") is None:
            return
        p = t["params"]
        dev = self.device
        params = {
            "log_ls": torch.as_tensor(np.asarray(p["log_ls"], np.float32), device=dev),
            "log_amp": torch.as_tensor(np.float32(p["log_amp"]), device=dev),
            "log_noise": torch.as_tensor(np.float32(p["log_noise"]), device=dev),
        }
        an, acap = int(t["anchor_n"]), int(t["anchor_cap"])
        if an < 0 or acap <= 0 or acap > self._buf.cap or an > self._buf.n:
            return  # stale/foreign trace — fall back to a cold anchor
        f = self._factor
        Xd, yd = self._buf.Xdev, self._buf.ydev
        f.anchor(gp_chol_full(Xd[:acap], yd[:acap], an, params), an, acap)
        for op, arg in t.get("ops", []):
            arg = int(arg)
            if op == "g":
                f.grow(arg)
            else:
                f.append_row(
                    gp_chol_append(f.L, Xd[:f.cap], yd[:f.cap], arg, params),
                    arg,
                )
        self._params = params
        self._params_host = {k: list(v) if isinstance(v, list) else v
                             for k, v in p.items()}

    def _aug_factor(self, pending, lie, n, fp):
        """Factor + buffers with pending lie rows appended (cached).

        Lie rows are ordinary finite observations to the masked gram, so
        they extend a COPY of the resident factor by the same O(n²) row
        updates — the base factor is never touched. Keyed by the pending
        fingerprint AND the factor version (anchors/rows).
        """
        key = (n, fp, self._factor.anchors, self._factor.rows)
        if self._aug_key != key:
            Xa, ya, ntot = self._buf.overlay(pending, lie)
            La = self._factor.L
            if Xa.shape[0] != self._factor.cap:
                La = _chol_grow(La, newcap=Xa.shape[0])
            for i in range(n, ntot):
                La = gp_chol_append(La, Xa, ya, i, self._params)
            self._aug_key = key
            self._aug = (Xa, ya, ntot, La)
        return self._aug

    def telemetry(self) -> Dict[str, int]:
        """Transfer/launch/factor counters (TPE's keys, the incremental
        Cholesky's and the suggest-ahead counters)."""
        return {
            "h2d_bytes": self._buf.h2d_bytes,
            "appends": self._buf.appends,
            "bulk_uploads": self._buf.bulk_uploads,
            "reallocs": self._buf.reallocs,
            "kernel_launches": self._launches,
            **self._factor.telemetry(),
            **self.suggest_ahead_telemetry(),
        }

    def seed_rng(self, seed: Optional[int]) -> None:
        super().seed_rng(seed)
        # launch → kernel lock order; getattr: called from the base ctor
        # before the locks exist. The factor/params survive — they are
        # data-derived, not stream state
        with getattr(self, "_launch_lock", threading.RLock()):
            with getattr(self, "_kernel_lock", threading.RLock()):
                self._kernel_seed = int(self.rng.integers(0, 2**31 - 1))
                self._prefetch = []
                self._prefetch_n_obs = -1
                self._pool_n = -1
                self._pool_idx = 0

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        # the launch lock waits out an in-flight speculative refill AND
        # covers the factor trace (mutated under launch, not kernel)
        with self._launch_lock, self._kernel_lock:
            s = super().state_dict()
            s["X"] = [x.tolist() for x in self._X]
            s["y"] = list(self._y)
            # unserved pool points travel so a restored instance continues
            # the same suggestion stream instead of refitting mid-pool
            s["prefetch"] = [dict(p) for p in self._prefetch]
            s["prefetch_n_obs"] = self._prefetch_n_obs
            s["pool_n"] = self._pool_n
            s["pool_idx"] = self._pool_idx
            if self._params is not None and self._factor.anchor_n >= 0:
                if self._params_host is None:
                    self._params_host = {
                        k: np.asarray(v.cpu().numpy(), np.float64).tolist()
                        for k, v in self._params.items()}
                # hyperparameters + the replay recipe (ints only)
                s["gp_params"] = dict(self._params_host)
                s["chol_trace"] = self._factor.trace()
            return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with self._launch_lock, self._kernel_lock:
            super().load_state_dict(state)
            self._X = [np.asarray(x, np.float32) for x in state.get("X", [])]
            self._y = list(state.get("y", []))
            # restored host lists may differ row-for-row from what the
            # device holds: drop the mirror, the next fit re-syncs
            self._buf.reset()
            self._factor.reset()
            self._params = None
            self._params_host = None
            self._aug_key = None
            self._aug = None
            self._restore_trace = None
            if state.get("gp_params") and state.get("chol_trace"):
                self._restore_trace = {
                    "params": dict(state["gp_params"]),
                    **state["chol_trace"],
                }
            self._prefetch = [dict(p) for p in state.get("prefetch", [])]
            self._prefetch_n_obs = int(state.get("prefetch_n_obs", -1))
            self._pool_n = int(state.get("pool_n", -1))
            self._pool_idx = int(state.get("pool_idx", 0))
