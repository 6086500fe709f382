"""Tree-structured Parzen Estimator (port of ``metaopt_tpu/algo/tpe.py``).

ref: src/metaopt/algo/tpe.py: split observations at the γ-quantile of the
objective into a good set (below) and bad set (above); fit per-dimension
adaptive-bandwidth Parzen estimators l(x) / g(x); draw candidates from l
and rank by EI ∝ l(x)/g(x); categorical dimensions via re-weighted category
frequencies; integers as quantized continuous (the UnitCube transform owns
quantization).

Config surface and defaults are the reference's: ``n_initial_points``,
``n_ei_candidates``, ``gamma``, ``prior_weight``, ``full_weight_num``,
``equal_weight``, ``pool_prefetch``, ``parallel_strategy``,
``suggest_prefetch_depth``, ``transfer_discount``, ``seed``. The port adds
``device``: the EI launches and the observation buffer run on ``cuda``
unless the caller passes another device (``device="cpu"``); without CUDA
the constructor raises.

The random phase and the kernel seed are numpy, so they equal the
reference's for the same seed. The EI phase runs
:func:`~metaopt_tpu_torch.ops.tpe_math.tpe_suggest_fused` on the device
over the pow2-padded observation buffer; its draws are keyed by
(kernel seed, observation count, pool index), as the reference's are.
``fuse_snapshot`` / ``fuse_commit`` / ``fuse_abort`` hand one pool refill
to the coordinator's fleet-fused plane, which serves a bucket of
experiments with one :func:`~metaopt_tpu_torch.ops.tpe_math.tpe_suggest_fleet`
launch; a fused pool is bit for bit the one the member's own refill would
have drawn.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metaopt_tpu_torch.algo.base import BaseAlgorithm, SuggestAhead, algo_registry
from metaopt_tpu_torch.algo.obs_buffer import ObservationBuffer
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ops.tpe_math import (
    adaptive_bandwidths,
    ei_scores,
    pad_pow2,
    split_pads,
    stream_seed,
    tpe_suggest_fused,
)
from metaopt_tpu_torch.space import Space, UnitCube
from metaopt_tpu_torch.utils.device import resolve_device


@algo_registry.register("tpe")
class TPE(SuggestAhead, BaseAlgorithm):
    def __init__(
        self,
        space: Space,
        seed: Optional[int] = None,
        n_initial_points: int = 20,
        n_ei_candidates: int = 24,
        gamma: float = 0.25,
        prior_weight: float = 1.0,
        full_weight_num: int = 25,
        equal_weight: bool = False,
        pool_prefetch: int = 8,
        parallel_strategy: Optional[str] = None,
        suggest_prefetch_depth: int = 1,
        transfer_discount: float = 0.25,
        device=None,
        **config: Any,
    ):
        super().__init__(
            space,
            seed=seed,
            n_initial_points=n_initial_points,
            n_ei_candidates=n_ei_candidates,
            gamma=gamma,
            prior_weight=prior_weight,
            full_weight_num=full_weight_num,
            equal_weight=equal_weight,
            pool_prefetch=pool_prefetch,
            parallel_strategy=parallel_strategy,
            suggest_prefetch_depth=suggest_prefetch_depth,
            transfer_discount=transfer_discount,
            **config,
        )
        self.device = resolve_device(device)
        self.n_initial_points = n_initial_points
        self.n_ei_candidates = n_ei_candidates
        self.gamma = gamma
        self.prior_weight = prior_weight
        self.full_weight_num = full_weight_num
        self.equal_weight = equal_weight
        self.pool_prefetch = max(1, int(pool_prefetch))
        #: weight multiplier on transfer-prior rows (observe_prior):
        #: seeded ancestor evidence shapes the fit but never outvotes
        #: locally-measured points once those exist
        self.transfer_discount = float(transfer_discount)

        # parallel strategy (the lineage's "liar" mechanism): in-flight
        # trials join the fit with a lie objective so concurrent workers
        # don't pile suggestions onto points already being evaluated.
        # mean = neutral lie, max = pessimistic (discourages revisiting)
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
        self._X: List[np.ndarray] = []   # unit-cube vectors, observation order
        self._y: List[float] = []
        self._pending_X: List[np.ndarray] = []   # lie rows, ephemeral
        self._pending_fp: tuple = ()
        self._aug_key = None   # (n_obs, pending_fp) the aug buffers match
        self._aug_X = self._aug_y = None
        self._aug_n = 0
        #: max categories across dims (table width for the kernel)
        self._kmax = int(max(1, self.cube.n_choices.max()))

        # device-resident observation buffer (padded to pow2 ≥ n+1 so the
        # prior pseudo-component always fits); observe() costs O(d)
        # host→device per new row at the next launch
        self._buf = ObservationBuffer(self.cube.n_dims, self.device)
        self._launches = 0                        # EI launch count
        self._n_choices_dev = None
        self._cont_mask_dev = None
        # draw seed: deterministic for a given ctor seed, OS-entropy
        # otherwise — unseeded parallel workers must NOT produce identical
        # suggestion streams (they would dup-collide on register forever)
        self._kernel_seed = int(self.rng.integers(0, 2**31 - 1))
        # PRNG stream position as (observation count, pool index within
        # that fit) — NOT a global launch counter: a speculative refill
        # that lands just before more observations arrive consumes a
        # launch that a differently-scheduled run never makes, and a
        # global counter would shift every later pool. Keying by
        # (n_obs, pool_idx) makes the served stream a pure function of
        # the observe/suggest call sequence, whatever the threads did.
        self._pool_n = -1                         # fit the index counts for
        self._pool_idx = 0                        # pools launched at that fit
        #: prefetched suggestions from the last launch, valid while the fit
        #: is unchanged (same observation count). A worker asking for ONE
        #: point then pays one launch per ``pool_prefetch`` points.
        self._prefetch: List[Dict[str, Any]] = []
        self._prefetch_n_obs = -1
        # - _kernel_lock guards the HOST state: observation lists, PRNG
        #   stream position, prefetch pool, pending set. Held only for
        #   snapshots and commits — never across a launch, so
        #   observe()/score()/set_pending() proceed while the device runs
        # - _launch_lock serializes launch+readback sequences (refill
        #   thread vs caller) so pools commit in stream order. Lock order
        #   is ALWAYS launch → kernel; never acquire _launch_lock while
        #   holding _kernel_lock
        # - observe() fires a speculative pool refill once EI is active, so
        #   the next suggest() finds its points already computed (or at
        #   least the launch already in flight) — thread lifecycle owned by
        #   the shared SuggestAhead mixin, work/locking owned here
        self._kernel_lock = threading.RLock()
        self._launch_lock = threading.RLock()
        self._ei_active = False
        # fleet-fused plane (coord/fuser.py): pools banked from a bucket
        # launch, and fused slices discarded because the fit moved
        self._fused_commits = 0
        self._fused_discards = 0
        self._init_suggest_ahead(suggest_prefetch_depth)

    # -- observe -----------------------------------------------------------
    def _observe_one(self, trial: Trial) -> None:
        # stored float32 from the start: the device buffer is float32
        # anyway, and state_dict→load_state_dict round-trips must
        # reproduce the serialized form bit-identically
        self._X.append(np.asarray(
            self.cube.transform(trial.params), np.float32))
        self._y.append(float(trial.objective))

    def _observe_batch(self, trials) -> bool:
        # mtpu: holds(_kernel_lock)  (observe() wraps super().observe())
        columns = getattr(trials, "columns", None)
        if columns is None:
            return False
        batch = columns()
        if batch is None:
            # non-columnar rows: let the per-trial path ingest them
            return False
        ids, cols, y = batch
        keep, seen = [], set()
        for i, tid in enumerate(ids):
            # replay-safe like the per-trial path, including duplicates
            # WITHIN one batch
            if tid in self._observed or tid in seen:
                continue
            seen.add(tid)
            keep.append(i)
        if not keep:
            return True
        if len(keep) != len(ids):
            cols = {k: [v[i] for i in keep] for k, v in cols.items()}
            y = y[keep]
            ids = [ids[i] for i in keep]
        # one column-major transform for the whole batch — bit-identical
        # per row to the transform(t.params) calls _observe_one would make
        X32 = np.asarray(
            self.cube.transform_columns(cols, len(ids)), np.float32)
        for i, tid in enumerate(ids):
            val = float(y[i])
            self._observed[tid] = val
            self._X.append(X32[i].copy())
            self._y.append(val)
        return True

    def observe(self, trials: List[Trial]) -> None:
        with self._kernel_lock:
            super().observe(trials)
        # with a parallel strategy the speculative refill waits for
        # set_pending (the Producer calls it right after observe): firing
        # here would race the pending update
        if not self.supports_pending:
            self._suggest_ahead_async()

    def set_pending(self, trials) -> None:
        """Reserved trials join the next fit with a lie objective.

        Ephemeral by design: rows live only until the pending set changes
        (fingerprinted by trial id), lie VALUES are recomputed at launch
        time from the live observations, and nothing here is serialized
        or counted toward ``is_done``. A changed pending set invalidates
        the prefetch pool — its points were chosen against a stale fit.
        For pending-enabled instances this is also the speculative-refill
        trigger (see observe).
        """
        if self.parallel_strategy is None:
            return
        with self._kernel_lock:
            live = [t for t in trials if t.id not in self._observed]
            fp = tuple(sorted(t.id for t in live))
            if fp != self._pending_fp:
                self._pending_fp = fp
                self._pending_X = [
                    self.cube.transform(t.params) for t in live
                ]
                self._prefetch = []
                self._prefetch_n_obs = -1
        self._suggest_ahead_async()

    # -- suggest -----------------------------------------------------------
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        with self._kernel_lock:
            if len(self._y) < self.n_initial_points:
                self._maybe_warmup_async()
                return [self.space.sample(1, seed=self.rng)[0]
                        for _ in range(num)]
        # EI path runs with the kernel lock RELEASED — _suggest_ei takes
        # launch → kernel in that order (observations only grow, so the
        # threshold check above cannot be invalidated by the gap)
        return self._suggest_ei(num)

    # -- background warm-up / speculative refill ---------------------------
    def _maybe_warmup_async(self) -> None:
        """Warm the EI path while the initial random trials run.

        There is no compile to hide here; the one call at the first EI
        launch's shapes loads the device's kernels and fills the caching
        allocator once, on tensors of its own with a fixed seed — pure
        function, instance state untouched.
        """
        if self._warmup_started:
            return
        self._warmup_started = True
        n0 = self.n_initial_points
        npad = pad_pow2(n0 + 1)
        n_out = pad_pow2(self.pool_prefetch, minimum=1)
        d = self.cube.n_dims
        g_pad, b_pad = split_pads(n0, self.gamma)
        dev = self.device
        n_choices = torch.as_tensor(self.cube.n_choices.astype(np.int32), device=dev)
        cont = torch.as_tensor(~self.cube.categorical_mask, device=dev)

        def work() -> None:
            try:
                y = torch.full((npad,), torch.inf, device=dev)
                y[:n0] = torch.arange(n0, dtype=torch.float32, device=dev)
                tpe_suggest_fused(
                    torch.full((npad, d), 0.5, device=dev), y, n0, 0, 0,
                    n_choices, cont, self.gamma, self.prior_weight,
                    self.full_weight_num, 0, 1.0,
                    n_cand=self.n_ei_candidates, n_out=n_out, kmax=self._kmax,
                    equal_weight=self.equal_weight, n_good_pad=g_pad, n_bad_pad=b_pad,
                ).cpu()
            except Exception as exc:  # warmup is best-effort
                logging.getLogger(__name__).debug("tpe warmup failed: %s", exc)

        self._warmup_thread = threading.Thread(
            target=work, name="tpe-warmup", daemon=True
        )
        self._warmup_thread.start()

    def _suggest_ahead_ready(self) -> bool:
        return self._ei_active and len(self._y) >= self.n_initial_points

    def _suggest_ahead_work(self) -> None:
        """Refill the prefetch pool off the critical path (SuggestAhead).

        Fires after ``observe()`` once EI suggesting is active. The refill
        holds the LAUNCH lock, so a concurrent ``suggest()`` simply waits
        for the fresh pool instead of racing it; either interleaving serves
        the same points from the same PRNG stream position. The kernel
        lock is only taken for the snapshot and the commit.

        ``suggest_prefetch_depth`` pools are kept banked: at the default
        depth 1 this refills exactly when the pool is stale or empty.
        """
        with self._launch_lock:
            for _ in range(self.suggest_prefetch_depth):
                with self._kernel_lock:
                    floor = self.pool_prefetch * (
                        self.suggest_prefetch_depth - 1)
                    if (self._prefetch_n_obs == len(self._y)
                            and len(self._prefetch) > floor):
                        return
                self._refill_pool()

    def _refill_pool(self, min_points: Optional[int] = None) -> None:
        """One launch appended to the prefetch (caller holds _launch_lock).

        Pools are ALWAYS ``pool_prefetch`` wide, so any interleaving of
        refill thread and caller produces the identical suggestion stream
        (same widths, same ``count`` order). A request larger than one
        pool batches several pools into the SAME launch (``_launch_ei``).

        The launch runs without the kernel lock; the result is committed
        only if the fit (observation count, pending set) is unchanged —
        a stale pool is discarded, burning pool indices that a replay
        never makes, which is safe because the stream is keyed by
        (n_obs, pool_idx), not by a global launch counter.
        """
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

    def _split(self) -> Tuple[np.ndarray, np.ndarray]:
        """Indices of good (below) / bad (above) observations."""
        y = np.asarray(self._y)
        n = len(y)
        n_below = max(1, int(math.ceil(self.gamma * n)))
        order = np.argsort(y, kind="stable")
        return order[:n_below], order[n_below:]

    def _weights(self, n: int) -> np.ndarray:
        """Observation-order weights: newest full_weight_num points get full
        weight, older ones ramp down linearly (the lineage's forgetting
        scheme); ``equal_weight`` disables the ramp.
        """
        if self.equal_weight or n <= self.full_weight_num:
            w = np.ones(n)
        else:
            ramp = np.linspace(1.0 / n, 1.0, n - self.full_weight_num)
            w = np.concatenate([ramp, np.ones(self.full_weight_num)])
        # transfer priors are the oldest rows; discount their vote (the
        # device fit applies the identical multiplier)
        if self._n_prior and self.transfer_discount != 1.0:
            w[: min(self._n_prior, n)] *= self.transfer_discount
        return w

    def _fit_set(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-dimension Parzen mixture + category tables for one subset."""
        X = np.stack([self._X[i] for i in idx])           # (n, d)
        n, d = X.shape
        w = self._weights(len(self._y))[idx]  # recency weight per observation

        npad = pad_pow2(n + 1)  # +1 for the prior pseudo-component
        mu = np.full((npad, d), 0.5)
        sigma = np.ones((npad, d))
        # adaptive bandwidths need per-dim sorting, which permutes components;
        # weights are stored per-dim to follow the same permutation
        logw_dims = np.full((npad, d), -np.inf)
        for j in range(d):
            order = np.argsort(X[:, j], kind="stable")
            mu[:n, j] = X[order, j]
            sigma[:n, j] = adaptive_bandwidths(X[order, j])
            logw_dims[:n, j] = np.log(np.clip(w[order], 1e-12, None))
        # prior pseudo-component: uniform-ish wide Gaussian at the center
        mu[n, :] = 0.5
        sigma[n, :] = 1.0
        logw_dims[n, :] = math.log(max(self.prior_weight, 1e-12))

        # categorical tables: re-weighted frequencies with prior smoothing
        tables = np.zeros((d, self._kmax))
        for j in range(d):
            k = int(self.cube.n_choices[j])
            if k <= 1:
                tables[j, 0] = 1.0
                continue
            counts = np.full(k, self.prior_weight)
            cat_idx = np.minimum((X[:, j] * k).astype(int), k - 1)
            np.add.at(counts, cat_idx, w)
            probs = counts / counts.sum()
            tables[j, :k] = probs
        log_tables = np.log(np.clip(tables, 1e-12, None))

        return {
            "mu": mu,
            "sigma": sigma,
            "logw": logw_dims,
            "cat_logp": log_tables,
            "n": n,
            "X": X,
            "w": w,
        }

    def telemetry(self) -> Dict[str, int]:
        """Device-traffic counters (cumulative): H2D payload bytes moved by
        the observation buffer and EI launches. Divide deltas of these by
        suggests served."""
        b = self._buf
        return {
            "h2d_bytes": b.h2d_bytes,
            "appends": b.appends,
            "bulk_uploads": b.bulk_uploads,
            "reallocs": b.reallocs,
            "kernel_launches": self._launches,
            "fused_commits": self._fused_commits,
            "fused_discards": self._fused_discards,
            **self.suggest_ahead_telemetry(),
        }

    def _suggest_ei(self, num: int) -> List[Dict[str, Any]]:
        """Serve from the prefetch pool; refill in uniform launches.

        Points are computed ``pool_prefetch`` at a time and later calls are
        served from the leftovers while the fit is unchanged. When
        ``observe()``'s speculative refill already ran (or is in flight —
        it holds the launch lock), this serves without touching the device.
        """
        served_hot = True
        with self._launch_lock:
            while True:
                with self._kernel_lock:
                    self._ei_active = True
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
        """One launch + one readback covering a request of ``num``.

        Returns the WHOLE pool the launch computed (``pool_w · n_pools``
        points, ≥ num) — the caller banks the overshoot in the prefetch.

        The snapshot (buffer sync, pending overlay, PRNG position
        allocation) happens under the kernel lock; the launch and its
        blocking readback (``.cpu()``, the one device sync per launch) run
        OUTSIDE it. Requests up to one pool wide launch a single pool of
        width pad_pow2(num); larger requests batch
        pad_pow2(ceil(num / pool_w)) pools of the uniform pool width into
        the SAME call — pool p is keyed (n_obs, count + p), exactly what p
        sequential launches would use.
        """
        with self._kernel_lock:
            if self._n_choices_dev is None:
                self._n_choices_dev = torch.as_tensor(
                    self.cube.n_choices.astype(np.int32), device=self.device)
                self._cont_mask_dev = torch.as_tensor(
                    ~self.cube.categorical_mask, device=self.device)
            self._buf.sync(self._X, self._y)
            n = len(self._y)
            if self._pool_n != n:
                self._pool_n, self._pool_idx = n, 0
            # pad the pool width to pow2 so the producer's shrinking pool
            # size near max_trials keeps the reference's launch shapes
            pool_w = pad_pow2(min(num, self.pool_prefetch), minimum=1)
            n_pools = 1
            if num > pool_w:
                n_pools = pad_pow2(-(-num // pool_w), minimum=1)
            count = self._pool_idx
            self._pool_idx += n_pools
            fit_seed = stream_seed(self._kernel_seed, n)
            X_dev, y_dev, n_eff = self._buf.Xdev, self._buf.ydev, n
            if (self._pending_X and self.parallel_strategy is not None
                    and n > 0):
                # lie rows ride as extra observations; values derive from
                # the live fit (mean = neutral, max = pessimistic). NaN
                # objectives (legal input — the split sends them to the
                # bad set) must not poison the lie
                lie = (float(np.nanmean(self._y))
                       if self.parallel_strategy == "mean"
                       else float(np.nanmax(self._y)))
                if np.isfinite(lie):
                    aug_key = (n, self._pending_fp)
                    if self._aug_key != aug_key:
                        # device-side compose: base rows copied on device,
                        # only the lie rows cross the host→device boundary
                        Xa, ya, ntot = self._buf.overlay(
                            self._pending_X, lie)
                        self._aug_key = aug_key
                        self._aug_X, self._aug_y = Xa, ya
                        self._aug_n = ntot
                    X_dev, y_dev = self._aug_X, self._aug_y
                    n_eff = self._aug_n
            g_pad, b_pad = split_pads(n_eff, self.gamma)
            self._launches += 1
        best = tpe_suggest_fused(
            X_dev, y_dev,
            n_eff, count, fit_seed,
            self._n_choices_dev, self._cont_mask_dev,
            self.gamma, self.prior_weight, self.full_weight_num,
            self._n_prior, self.transfer_discount,
            n_cand=self.n_ei_candidates,
            n_out=pool_w,
            kmax=self._kmax,
            equal_weight=self.equal_weight,
            n_good_pad=g_pad,
            n_bad_pad=b_pad,
            n_pools=n_pools,
        ).cpu().numpy()
        fid = self.space.fidelity
        out = []
        for row in best:
            pt = self.cube.untransform(row)
            if fid is not None:
                pt[fid.name] = fid.high
            out.append(pt)
        return out

    # -- fleet-fused suggest plane (coord/fuser.py) ------------------------
    def fuse_snapshot(self):
        """Freeze one pool-refill launch for a fleet bucket.

        Mirrors ``_launch_ei``'s snapshot phase EXACTLY (buffer sync,
        pending-lie overlay, pad computation, pool-index allocation, draw
        seed) for a single pool of width ``pad_pow2(pool_prefetch)`` — the
        refill SuggestAhead would have paid. Caller holds ``_launch_lock``
        from here through ``fuse_commit``, so the captured device buffers
        cannot be replaced by a concurrent sync and the allocated pool
        index cannot be reordered. Returns None (per-experiment path) in
        the random phase or when the prefetch pool is already fresh and
        non-empty (no demand).
        """
        from metaopt_tpu_torch.algo.base import FuseSnapshot

        with self._kernel_lock:
            n = len(self._y)
            if n < self.n_initial_points:
                return None
            if self._prefetch_n_obs == n and self._prefetch:
                return None  # no demand: the banked pool is still fresh
            if self._n_choices_dev is None:
                self._n_choices_dev = torch.as_tensor(
                    self.cube.n_choices.astype(np.int32), device=self.device)
                self._cont_mask_dev = torch.as_tensor(
                    ~self.cube.categorical_mask, device=self.device)
            self._buf.sync(self._X, self._y)
            if self._pool_n != n:
                self._pool_n, self._pool_idx = n, 0
            pool_w = pad_pow2(self.pool_prefetch, minimum=1)
            count = self._pool_idx
            self._pool_idx += 1
            fit_seed = stream_seed(self._kernel_seed, n)
            X_dev, y_dev, n_eff = self._buf.Xdev, self._buf.ydev, n
            if (self._pending_X and self.parallel_strategy is not None
                    and n > 0):
                lie = (float(np.nanmean(self._y))
                       if self.parallel_strategy == "mean"
                       else float(np.nanmax(self._y)))
                if np.isfinite(lie):
                    aug_key = (n, self._pending_fp)
                    if self._aug_key != aug_key:
                        Xa, ya, ntot = self._buf.overlay(
                            self._pending_X, lie)
                        self._aug_key = aug_key
                        self._aug_X, self._aug_y = Xa, ya
                        self._aug_n = ntot
                    X_dev, y_dev = self._aug_X, self._aug_y
                    n_eff = self._aug_n
            g_pad, b_pad = split_pads(n_eff, self.gamma)
            return FuseSnapshot(
                family="tpe",
                static_key=(
                    int(X_dev.shape[0]), self.cube.n_dims,
                    self.n_ei_candidates, pool_w, self._kmax,
                    bool(self.equal_weight), g_pad, b_pad, str(self.device),
                ),
                arrays={
                    "X": X_dev, "y": y_dev, "n": n_eff, "count": count,
                    "fit_seed": fit_seed,
                    "n_choices": self._n_choices_dev,
                    "cont_mask": self._cont_mask_dev,
                    "gamma": self.gamma,
                    "prior_weight": self.prior_weight,
                    "full_weight_num": self.full_weight_num,
                    "n_prior": self._n_prior,
                    "transfer_discount": self.transfer_discount,
                },
                count=count,
                fit_id=(n, self._pending_fp),
            )

    def fuse_commit(self, snapshot, rows) -> bool:
        """Bank one bucket-launch slice into the prefetch pool.

        Same commit protocol as ``_refill_pool``: discard if the fit moved
        between snapshot and launch (the pool index is burned — safe under
        (n_obs, pool_idx) keying). Caller still holds ``_launch_lock``, so
        no other launch can have allocated indices behind our back: a
        committed slice lands in the exact stream position a solo refill
        at ``snapshot.count`` would have.
        """
        fid = self.space.fidelity
        pts = []
        for row in np.asarray(rows):
            pt = self.cube.untransform(row)
            if fid is not None:
                pt[fid.name] = fid.high
            pts.append(pt)
        with self._kernel_lock:
            if (len(self._y), self._pending_fp) != snapshot.fit_id:
                self._fused_discards += 1
                return False
            if self._prefetch_n_obs != len(self._y):
                self._prefetch = []
                self._prefetch_n_obs = len(self._y)
            self._prefetch.extend(pts)
            self._fused_commits += 1
            return True

    def fuse_abort(self, snapshot) -> None:
        """Un-allocate the snapshot's pool index (singleton bucket).

        Safe because the caller still holds ``_launch_lock`` — the only
        other allocator — so ``_pool_idx`` can only have moved if the fit
        changed (pool reset), in which case we leave it alone and the
        index is burned (still correct, just a wasted draw seed).
        """
        with self._kernel_lock:
            if (self._pool_n == snapshot.fit_id[0]
                    and self._pool_idx == snapshot.count + 1):
                self._pool_idx = snapshot.count

    def score(self, point: Dict[str, Any]) -> float:
        """EI score of an arbitrary point under the current l/g fit."""
        with self._kernel_lock:
            return self._score_locked(point)

    def _score_locked(self, point: Dict[str, Any]) -> float:
        if len(self._y) < max(2, self.n_initial_points):
            return 0.0
        below, above = self._split()
        good, bad = self._fit_set(below), self._fit_set(above)
        vec = self.cube.transform(point)[None, :]
        k = np.maximum(self.cube.n_choices, 1)
        cat = np.minimum((vec * k[None, :]).astype(np.int32), (k - 1)[None, :])
        cont_mask = (~self.cube.categorical_mask).astype(np.float32)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        s = ei_scores(
            dev(vec),
            dev(good["mu"]), dev(good["sigma"]), dev(good["logw"]),
            dev(bad["mu"]), dev(bad["sigma"]), dev(bad["logw"]),
            dev(cont_mask), dev(cat, torch.int64),
            dev(good["cat_logp"]), dev(bad["cat_logp"]),
        )
        return float(s[0])

    def seed_rng(self, seed: Optional[int]) -> None:
        super().seed_rng(seed)
        # launch → kernel lock order; getattr: called from the base ctor
        # before the locks exist
        with getattr(self, "_launch_lock", threading.RLock()):
            with getattr(self, "_kernel_lock", threading.RLock()):
                self._kernel_seed = int(self.rng.integers(0, 2**31 - 1))
                self._pool_n = -1
                self._pool_idx = 0
                self._prefetch = []
                self._prefetch_n_obs = -1

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        # the launch lock waits out an in-flight speculative refill: its
        # pool must either commit (and serialize with the state) or not
        # have allocated its stream position yet
        with self._launch_lock, self._kernel_lock:
            s = super().state_dict()
            s["X"] = [x.tolist() for x in self._X]
            s["y"] = list(self._y)
            s["pool_n"] = self._pool_n
            s["pool_idx"] = self._pool_idx
            # unserved prefetched points travel with the state: a restored
            # instance must continue the exact suggestion stream
            s["prefetch"] = [dict(p) for p in self._prefetch]
            s["prefetch_n_obs"] = self._prefetch_n_obs
            return s

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with self._launch_lock, self._kernel_lock:
            super().load_state_dict(state)
            self._X = [np.asarray(x, np.float32) for x in state.get("X", [])]
            self._y = list(state.get("y", []))
            self._pool_n = int(state.get("pool_n", -1))
            self._pool_idx = int(state.get("pool_idx", 0))
            self._buf.reset()      # restored lists may differ at same count
            self._aug_key = None   # pending overlay may alias (n, fp)
            self._prefetch = [dict(p) for p in state.get("prefetch", [])]
            self._prefetch_n_obs = int(state.get("prefetch_n_obs", -1))
