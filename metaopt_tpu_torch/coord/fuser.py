"""Fleet-fused suggest plane: cross-experiment batched acquisition (port of
``metaopt_tpu/coord/fuser.py``).

At many resident experiments every hosted TPE/GP-BO instance runs its own
acquisition launches on its own SuggestAhead thread: O(resident
experiments) launch sequences per produce tick. :class:`SuggestFuser`
collapses that to O(buckets):

- each tick it sweeps the resident hosted algorithms for pending produce
  demand (an empty or stale prefetch pool), ordered by the tenancy
  scheduler's unmet share (``FairProduceScheduler.grant_order``);
- eligible experiments are grouped into BUCKETS keyed by
  ``(algo family, static_key)`` — the static key carries every shape the
  batched body fixes (padded dim, padded obs-count, good/bad pads,
  candidate/pool widths, kmax, equal_weight) and the device, all padded to
  powers of two upstream, so nearby observation counts share a bucket;
  buckets are padded to pow2 members, capped at ``bucket_max``;
- each bucket's device-resident ``ObservationBuffer``s are stacked along a
  new leading axis and served by ONE batched launch
  (``tpe_suggest_fleet`` / ``gp_acquire_fleet``), whose result rows fan
  back into each algorithm's prefetch pool via ``fuse_commit`` — the
  fused plane FEEDS SuggestAhead off the reply path, it does not replace
  it;
- a member that doesn't fit a bucket (singleton static key, GP mid-refit,
  random phase, an experiment mid-launch on its own thread) simply isn't
  fused — its own refill serves it exactly as before.

A bucket launch that raises is not replaced by solo launches: the fuser
hands every unlaunched member's pool index back (``fuse_abort``) and the
error propagates to the tick's caller, which logs it and counts it in
``telemetry()["launch_errors"]``.

Determinism: a fused suggestion is BIT-identical, on the CPU, to what the
experiment's own refill would have produced. ``fuse_snapshot`` allocates
the pool index from the experiment's own (n_obs, pool_idx) stream and the
bucket launch draws each member's pool from that member's own generator,
exactly like a solo launch; the fleet launch runs the SAME body the solo
launch runs (the solo launch is its B = 1 case, ops/tpe_math.py /
algo/gp_bo.py); and the fuser holds each member's launch lock from
snapshot through commit so no concurrent launch can reorder the stream.

Locking: ``_launch_lock``s are acquired NON-blocking (a busy experiment is
skipped, not waited on) and the fuser is the only multi-experiment
acquirer in the process, so no cycle is possible. On a live server every
swept experiment is counted in ``_exp_inflight`` under ``_map_cv`` for the
whole tick — eviction drains through the same fence as any dispatch, so a
bucket can never hold a buffer whose experiment is being captured. The
fuser's own telemetry counters are guarded by ``_lock``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["SuggestFuser"]


class SuggestFuser:
    """Coordinator-level cross-experiment acquisition batcher.

    ``server`` is the owning :class:`~metaopt_tpu_torch.coord.server.CoordServer`
    (None for the bare-algos harness that measurements and the property
    tests drive via :meth:`fuse`). ``bucket_max`` caps members per bucket
    launch; it is rounded down to a power of two so padded bucket sizes
    never overshoot it.
    """

    def __init__(self, server: Optional[Any] = None,
                 bucket_max: int = 32) -> None:
        self.server = server
        bucket_max = max(2, int(bucket_max))
        # round DOWN to pow2: pad_pow2(B) for any admitted B stays ≤ cap
        while bucket_max & (bucket_max - 1):
            bucket_max &= bucket_max - 1
        self.bucket_max = bucket_max
        #: guards the telemetry counters below (tick thread vs
        #: tenant_stats readers)
        self._lock = threading.Lock()
        self._ticks = 0
        self._bucket_launches = 0
        self._fused_experiments = 0
        self._fallback_experiments = 0
        self._last_buckets = 0
        self._last_fused = 0
        self._last_occupancy = 0.0
        self._launch_errors = 0

    # -- core (server-free): snapshot → bucket → launch → commit -----------
    def fuse(self, named_algos: Sequence[Tuple[str, Any]]) -> Dict[str, int]:
        """One fused sweep over ``(name, algorithm)`` pairs.

        Returns ``{"launches", "fused", "fallback"}`` for this sweep.
        Safe against anything the per-experiment path does concurrently:
        a member mid-launch fails the non-blocking lock acquire and is
        skipped; a member whose fit moves between snapshot and commit
        discards its slice (burned pool index, legal under the stream
        doctrine). A bucket launch that raises hands back the pool index
        of every member not yet served and re-raises.
        """
        held: List[Tuple[str, Any, Any, Any]] = []  # (name, algo, lock, snap)
        launches = fused = fallback = 0
        occupancy: List[int] = []
        try:
            for name, algo in named_algos:
                lock = getattr(algo, "_launch_lock", None)
                if lock is None or not hasattr(algo, "fuse_snapshot"):
                    continue
                if not lock.acquire(blocking=False):
                    continue  # mid-launch on its own thread — skip
                snap = None
                try:
                    snap = algo.fuse_snapshot()  # mtpu: lint-ok MTL004 the acquire above holds its _launch_lock
                except Exception:
                    log.exception("fuse_snapshot failed for %r", name)
                if snap is None:
                    lock.release()
                    continue
                held.append((name, algo, lock, snap))

            buckets: Dict[tuple, List[Tuple[str, Any, Any]]] = {}
            for name, algo, _lock, snap in held:
                key = (snap.family,) + tuple(snap.static_key)
                buckets.setdefault(key, []).append((name, algo, snap))

            chunks = []
            for key, members in buckets.items():
                for i in range(0, len(members), self.bucket_max):
                    chunks.append((key, members[i:i + self.bucket_max]))
            for c, (key, chunk) in enumerate(chunks):
                if len(chunk) < 2:
                    # a bucket of one gains nothing over the solo path:
                    # hand the pool index back (nothing else can have
                    # allocated behind the held launch lock) and let
                    # SuggestAhead serve it
                    for _n, algo, snap in chunk:
                        algo.fuse_abort(snap)
                    fallback += len(chunk)
                    continue
                try:
                    out = self._launch_bucket(key[0], chunk)
                except BaseException:
                    # no solo launch stands in for a failed bucket: every
                    # member not yet served gets its pool index back, so
                    # the stream stays where a never-attempted fusion
                    # leaves it, and the error reaches the caller
                    for _k, rest in chunks[c:]:
                        for _n, algo, snap in rest:
                            algo.fuse_abort(snap)
                    with self._lock:
                        self._launch_errors += 1
                    raise
                launches += 1
                occupancy.append(len(chunk))
                for j, (_n, algo, snap) in enumerate(chunk):
                    if algo.fuse_commit(snap, out[j]):
                        fused += 1
        finally:
            for _name, _algo, lock, _snap in held:
                lock.release()
        with self._lock:
            self._bucket_launches += launches
            self._fused_experiments += fused
            self._fallback_experiments += fallback
            self._last_buckets = len(occupancy)
            self._last_fused = fused
            self._last_occupancy = (
                sum(occupancy) / len(occupancy) if occupancy else 0.0)
        return {"launches": launches, "fused": fused, "fallback": fallback}

    def _launch_bucket(self, family: str,
                       chunk: Sequence[Tuple[str, Any, Any]]) -> np.ndarray:
        """ONE batched launch + ONE readback for a whole bucket.

        The batch axis is padded to pow2 by repeating member 0 (the body is
        row-independent, so pad rows cannot perturb real rows); pad rows
        are simply never committed. Device columns (buffers, factors,
        hyperparameters, space encodings) go to the fleet function as
        sequences, which it stacks with one kernel per column; host scalars
        (counts, draw seeds, hyperparameters) go as lists.
        """
        from metaopt_tpu_torch.ops.tpe_math import pad_pow2

        snaps = [s for (_n, _a, s) in chunk]
        B = len(snaps)
        Bpad = pad_pow2(B, minimum=1)
        cols: Dict[str, List[Any]] = {}
        for k in snaps[0].arrays:
            vals = [s.arrays[k] for s in snaps]
            cols[k] = vals + [vals[0]] * (Bpad - B)
        sk = snaps[0].static_key
        if family == "tpe":
            from metaopt_tpu_torch.ops.tpe_math import tpe_suggest_fleet

            out = tpe_suggest_fleet(
                cols["X"], cols["y"], cols["n"], cols["count"], cols["fit_seed"],
                cols["n_choices"], cols["cont_mask"], cols["gamma"],
                cols["prior_weight"], cols["full_weight_num"],
                cols["n_prior"], cols["transfer_discount"],
                n_cand=sk[2], n_out=sk[3], kmax=sk[4], equal_weight=sk[5],
                n_good_pad=sk[6], n_bad_pad=sk[7], n_pools=1,
            )
        elif family == "gp":
            from metaopt_tpu_torch.algo.gp_bo import gp_acquire_fleet

            params = {"log_ls": cols["log_ls"], "log_amp": cols["log_amp"],
                      "log_noise": cols["log_noise"]}
            out = gp_acquire_fleet(
                cols["X"], cols["y"], cols["L"], cols["n"],
                cols["mu"], cols["sd"], cols["fit_seed"], cols["count"], params,
                n_cand=sk[2], n_out=sk[3], n_pools=1,
            )
        else:
            raise ValueError(f"unknown fuse family {family!r}")
        return out.cpu().numpy()

    # -- server tick --------------------------------------------------------
    def tick(self) -> Dict[str, int]:
        """One demand sweep over the owning server's resident producers.

        Fence protocol mirrors ``CoordServer._handle``: every swept
        experiment is registered in ``_exp_inflight`` under ``_map_cv``
        (skipping any that are migrating/evicting), so an eviction's
        drain wait covers the whole snapshot→launch→commit window — a
        bucket can never hold the device buffers of an experiment whose
        state is being captured.
        """
        srv = self.server
        if srv is None:
            raise RuntimeError("SuggestFuser.tick() needs an owning server")
        if srv._stopping.is_set():
            return {"launches": 0, "fused": 0, "fallback": 0}
        with srv._producers_guard:
            items = [(name, entry[0].algorithm)
                     for name, entry in srv._producers.items()]
        if items:
            # sweep order = tenancy unmet share: when a tick's budget runs
            # out mid-sweep, under-served tenants got their pools warmed
            # first (the scheduler "hands the fuser its grant batch")
            with srv._tenant_lock:
                tenant_of = {n: srv._tenant_of.get(n, "default")
                             for n, _ in items}
                prio = srv._sched.grant_order(set(tenant_of.values()))
            items.sort(key=lambda p: -prio.get(tenant_of[p[0]], 1.0))
        admitted: List[Tuple[str, Any]] = []
        with srv._map_cv:
            for name, algo in items:
                if name in srv._migrating:
                    continue
                srv._exp_inflight[name] = srv._exp_inflight.get(name, 0) + 1
                admitted.append((name, algo))
        try:
            stats = self.fuse(admitted)
        finally:
            with srv._map_cv:
                for name, _ in admitted:
                    n = srv._exp_inflight.get(name, 0) - 1
                    if n <= 0:
                        srv._exp_inflight.pop(name, None)
                    else:
                        srv._exp_inflight[name] = n
                if srv._migrating:
                    srv._map_cv.notify_all()
        with self._lock:
            self._ticks += 1
        return stats

    # -- telemetry ----------------------------------------------------------
    def telemetry(self) -> Dict[str, Any]:
        """Counters for ``tenant_stats`` / ``tenants``."""
        with self._lock:
            return {
                "ticks": self._ticks,
                "bucket_launches": self._bucket_launches,
                "fused_experiments": self._fused_experiments,
                "fallback_experiments": self._fallback_experiments,
                "last_buckets": self._last_buckets,
                "last_fused": self._last_fused,
                "last_occupancy": round(self._last_occupancy, 3),
                "launch_errors": self._launch_errors,
            }
