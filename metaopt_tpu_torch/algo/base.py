"""The algorithm contract (port of ``metaopt_tpu/algo/base.py``).

``suggest(num)``, ``observe(trials)`` with its per-trial and columnar
hooks, transfer priors (``observe_prior`` / ``n_prior``), the
parallel-strategy ``set_pending``, ``is_done``, ``score``, the ``judge``
early-stop hook, ``seed_rng``, ``configuration``, the
``state_dict`` snapshots, the ``cohort_size`` hook, ``should_suspend``, the
registry and :func:`make_algorithm`; and the suggest-ahead mixin
(:class:`SuggestAhead`) with its atexit drain. Not ported yet: the
fleet-fused hooks (``FuseSnapshot``, ``fuse_*``), which serve the
coordinator.

``observe`` takes :class:`~metaopt_tpu_torch.ledger.trial.Trial` objects
(they carry params, objective, fidelity, status, and lineage in one value
object) instead of parallel points/results lists.
"""

from __future__ import annotations

import atexit
import logging
import threading
import weakref
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space
from metaopt_tpu_torch.utils.registry import Registry

algo_registry: Registry = Registry("algorithm")

#: live SuggestAhead instances whose background threads must finish before
#: interpreter teardown — a daemon thread launching device work at
#: shutdown aborts the process
_live_instances: "weakref.WeakSet[SuggestAhead]" = weakref.WeakSet()


@atexit.register
def _drain_background_threads() -> None:
    for inst in list(_live_instances):
        for t in (inst._warmup_thread, inst._refill_thread):
            if t is not None and t.is_alive():
                t.join(timeout=30.0)


class SuggestAhead:
    """Speculative suggest-ahead, shared by the pool-serving algorithms.

    The pattern every device-backed algorithm here converged on: the
    worker spends its inter-trial time on ledger RPCs and subprocess
    teardown, which is exactly the window the next pool's kernel launch +
    readback (or generation advance) can hide in. This mixin owns the
    thread lifecycle and telemetry; the ALGORITHM owns the work and its
    locking:

    - call :meth:`_init_suggest_ahead` from the constructor;
    - implement :meth:`_suggest_ahead_work` — prepare the next pool under
      the subclass's own locks (TPE doctrine: launch → kernel, never the
      reverse);
    - optionally override :meth:`_suggest_ahead_ready` — a cheap unlocked
      gate checked before any thread is spawned;
    - fire :meth:`_suggest_ahead_async` wherever the fit changes
      (``observe`` / ``set_pending``);
    - report :meth:`_record_pool_hit` / :meth:`_record_pool_miss` when a
      ``suggest`` is served from the prepared pool vs. pays an inline
      launch — the prefetch hit rate derives from these.

    ``suggest_prefetch_depth`` scales how far ahead the worker runs: 1
    keeps the historical behaviour (refill only a stale or empty pool),
    N > 1 keeps N pools' worth of points banked so a burst of produce
    cycles is answered without ever touching the device inline. Extra
    pools burn PRNG pool indices at the current fit, which the stream
    doctrine explicitly allows (keys are ``(n_obs, pool_idx)``, and
    unserved pools are discarded on fit change), so the SERVED stream
    stays a pure function of the observe/suggest call sequence.

    At interpreter shutdown a module-level ``atexit`` hook joins the
    background threads of every live instance (daemon threads that launch
    device work during teardown abort the process).
    """

    _warmup_thread: Optional[threading.Thread] = None
    _refill_thread: Optional[threading.Thread] = None

    def _init_suggest_ahead(self, prefetch_depth: int = 1) -> None:
        self.suggest_prefetch_depth = max(1, int(prefetch_depth))
        self._warmup_started = False
        self._warmup_thread = None
        # guards the spawn decision and the telemetry counters: both are
        # touched from the caller thread and the refill thread, and the
        # check-then-spawn below must be atomic or two near-simultaneous
        # fires launch two refill threads racing on the same pool
        self._ahead_lock = threading.Lock()
        self._refill_thread = None
        self._ahead_launches = 0
        self._ahead_hits = 0
        self._ahead_misses = 0
        _live_instances.add(self)

    # -- subclass surface --------------------------------------------------
    def _suggest_ahead_ready(self) -> bool:
        """Cheap gate checked (unlocked) before spawning the worker."""
        return True

    def _suggest_ahead_work(self) -> None:
        """Prepare the next pool(s); runs on the background thread under
        the subclass's own locks."""
        raise NotImplementedError

    # -- spawning the refill -----------------------------------------------
    def _suggest_ahead_async(self) -> None:
        """Start preparing the next pool the moment the fit changes.

        At most one live refill thread per instance; a fire while one is
        running is dropped (the running worker re-checks freshness under
        the subclass's locks before committing, so nothing is lost).
        Failures are swallowed — the next ``suggest`` simply retries
        inline.
        """
        if not self._suggest_ahead_ready():
            return

        def work() -> None:
            try:
                self._suggest_ahead_work()
            except Exception as exc:  # next suggest() will retry inline
                logging.getLogger(__name__).debug(
                    "suggest-ahead refill failed: %s", exc)

        with self._ahead_lock:
            if (self._refill_thread is not None
                    and self._refill_thread.is_alive()):
                return
            self._ahead_launches += 1
            # start under the lock: an unstarted Thread reports
            # is_alive() False, so publishing it before start() would
            # let a concurrent fire spawn a second refill
            self._refill_thread = threading.Thread(
                target=work, name=f"{type(self).__name__.lower()}-refill",
                daemon=True,
            )
            self._refill_thread.start()

    def drain_suggest_ahead(self, timeout: float = 60.0) -> None:
        """Join in-flight background threads (tests, measurements, shutdown)."""
        with self._ahead_lock:
            refill = self._refill_thread
        for t in (refill, self._warmup_thread):
            if t is not None and t.is_alive():
                t.join(timeout=timeout)

    # -- telemetry ---------------------------------------------------------
    def _record_pool_hit(self) -> None:
        with self._ahead_lock:
            self._ahead_hits += 1

    def _record_pool_miss(self) -> None:
        with self._ahead_lock:
            self._ahead_misses += 1

    def suggest_ahead_telemetry(self) -> Dict[str, int]:
        """Suggest-ahead counters: hits = suggests served from a prepared
        pool without an inline launch; misses paid one."""
        with self._ahead_lock:
            return {
                "prefetch_hits": self._ahead_hits,
                "prefetch_misses": self._ahead_misses,
                "ahead_launches": self._ahead_launches,
            }


class BaseAlgorithm(ABC):
    """Pluggable optimizer over a :class:`Space`.

    The Producer drives it: ``observe(completed_trials)`` then
    ``suggest(num)``; both must be cheap relative to trial runtime, and
    ``suggest`` may return fewer points than asked (or none, when the
    algorithm is waiting on in-flight trials — e.g. ASHA rungs full).
    """

    #: set by multi-fidelity algorithms; checked at construction time
    requires_fidelity: bool = False

    def __init__(self, space: Space, seed: Optional[int] = None, **config: Any):
        self.space = space
        self._config = dict(config, seed=seed)
        if self.requires_fidelity and space.fidelity is None:
            raise ValueError(
                f"{type(self).__name__} needs a fidelity dimension, e.g. "
                "epochs~fidelity(1, 16, base=4)"
            )
        self.rng = np.random.default_rng(seed)
        self._observed: Dict[str, float] = {}  # trial id -> objective
        #: how many of the oldest observations were seeded from an
        #: ancestor experiment (transfer warm-start) rather than measured
        #: in THIS experiment — algorithms may discount them
        self._n_prior = 0

    # -- core contract ----------------------------------------------------
    @abstractmethod
    def suggest(self, num: int = 1) -> List[Dict[str, Any]]:
        """Propose up to ``num`` new points (param dicts incl. fidelity)."""

    def observe(self, trials: Sequence[Trial]) -> None:
        """Ingest completed trials. Idempotent per trial id (replay-safe).

        Tries the columnar fast path first: when the sequence is a
        columnar batch (the ledger archive's ``CompletedBatch``) and the
        subclass ingests it wholesale via :meth:`_observe_batch`, no
        per-trial ``Trial`` objects are materialized at all. Any refusal
        (the default hook, a plain list, exotic rows) falls back to the
        per-trial loop — same stream, same idempotency.
        """
        if len(trials) and self._observe_batch(trials):
            return
        for t in trials:
            if t.id in self._observed:
                continue
            obj = t.objective
            if obj is None:
                continue
            self._observed[t.id] = obj
            self._observe_one(t)

    def _observe_batch(self, trials: Sequence[Trial]) -> bool:
        """Columnar ingest hook. Subclasses that can consume a whole
        batch straight from its value columns (``CompletedBatch.
        columns()``) override this and return True when the batch is
        FULLY ingested — including the ``_observed`` idempotency
        bookkeeping ``observe`` otherwise does per trial. Returning
        False (the default) routes the batch through the per-trial path.
        """
        return False

    def _observe_one(self, trial: Trial) -> None:  # subclass hook
        pass

    def observe_prior(self, trials: Sequence[Trial]) -> None:
        """Seed the buffer from an ANCESTOR experiment's completed trials.

        Transfer warm-start (EVC): points enter through the normal
        ``observe`` path — so every subclass buffer stays consistent —
        but are counted in ``n_prior`` so acquisition can discount them
        against locally-measured evidence. Must be called before any
        real ``observe`` (priors occupy the oldest rows). The
        producer's transfer-prior sourcing (EVC) is not ported yet.
        """
        before = len(self._observed)
        self.observe(trials)
        self._n_prior += len(self._observed) - before

    @property
    def n_prior(self) -> int:
        return self._n_prior

    #: True when the instance wants the Producer to report in-flight
    #: (reserved) trials each cycle via :meth:`set_pending` — the
    #: lineage's parallel-strategy ("liar") mechanism
    supports_pending: bool = False

    def set_pending(self, trials: Sequence[Trial]) -> None:
        """In-flight trials, for parallel-strategy algorithms. No-op here.

        Called by the Producer each produce cycle (when
        ``supports_pending``) with the experiment's reserved trials, so
        an async algorithm can avoid re-suggesting near points whose
        evaluations are still running. Ephemeral: never serialized in
        ``state_dict``, never counted in ``n_observed``/``is_done``.
        """

    @property
    def n_observed(self) -> int:
        return len(self._observed)

    @property
    def is_done(self) -> bool:
        """True when the algorithm cannot usefully continue (space exhausted)."""
        return self.n_observed >= self.space.cardinality

    # -- optional hooks ----------------------------------------------------
    @property
    def cohort_size(self) -> Optional[int]:
        """Natural same-fidelity evaluation-pool size, if the algorithm
        has one (population algorithms: their generation). The reference's
        batched hunt sizes its pools from this; the port's is not ported
        yet."""
        return None

    def score(self, point: Dict[str, Any]) -> float:
        """Rank candidate points (higher is better); default indifferent."""
        return 0.0

    def judge(self, trial: Trial, partial: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
        """Dynamic early-stop hook: given streaming partial results
        (``[{"objective": ..., "step": ...}, ...]``), return ``{"stop":
        True}`` to prune the running trial, or None to let it run."""
        return None

    def should_suspend(self, trial: Trial) -> bool:
        """Park a freshly reserved trial as ``suspended`` instead of
        running it (``resume`` flips it back to ``new``)."""
        return False

    # -- reproducibility / persistence ------------------------------------
    def seed_rng(self, seed: Optional[int]) -> None:
        self.rng = np.random.default_rng(seed)

    @property
    def configuration(self) -> Dict[str, Any]:
        """Serializable constructor config (for the experiment document)."""
        name = type(self).__name__.lower()
        return {name: {k: v for k, v in self._config.items()}}

    def state_dict(self) -> Dict[str, Any]:
        return {"observed": dict(self._observed),
                "n_prior": self._n_prior}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._observed = dict(state.get("observed", {}))
        self._n_prior = int(state.get("n_prior", 0))


def _load_plugin(name: str) -> bool:
    """Third-party discovery (the lineage's pkg_resources plugin role).

    An installed distribution can expose algorithms via the
    ``metaopt_tpu_torch.algorithms`` entry-point group; loading the entry point
    imports the module, whose ``@algo_registry.register`` decorator does
    the rest. Returns True if something matching ``name`` was loaded.
    """
    try:
        from importlib.metadata import entry_points

        eps = list(entry_points(group="metaopt_tpu_torch.algorithms"))
    except Exception:  # discovery failure must not mask the KeyError
        return False
    for ep in eps:
        if ep.name.lower() == name.lower():
            # load OUTSIDE the guard: a plugin that fails to import must
            # surface ITS error, not a bare unknown-algorithm KeyError
            ep.load()
            return name.lower() in algo_registry
    return False


#: registered name → the module of this package that registers it. The
#: modules load when an algorithm is built (or its class is imported from
#: ``metaopt_tpu_torch.algo``), so a process that builds a numpy algorithm
#: (random search, ASHA, ...) or none (``status``) never imports torch.
BUILTIN_MODULES = {
    "random": "random_search", "grid_search": "grid_search",
    "gradient_descent": "gradient_descent", "gradientdescent": "gradient_descent",
    "tpe": "tpe", "motpe": "motpe", "gp": "gp_bo", "cmaes": "cmaes", "cma": "cmaes",
    "hyperband": "hyperband", "asha": "asha", "bohb": "bohb",
    "evolution_es": "evolution_es", "evolutiones": "evolution_es",
    "pbt": "pbt", "dehb": "dehb",
}


def _load_builtin(name: str) -> None:
    """Import the module of this package that registers ``name``; for an
    unknown name, all of them (so the error lists every algorithm)."""
    import importlib

    key = name.lower()
    mods = ([BUILTIN_MODULES[key]] if key in BUILTIN_MODULES
            else sorted(set(BUILTIN_MODULES.values())))
    for mod in mods:
        importlib.import_module(f"metaopt_tpu_torch.algo.{mod}")


def make_algorithm(space: Space, config: Dict[str, Any]) -> BaseAlgorithm:
    """Build from ``{"asha": {...}}``-style config (single key = algo name)."""
    if len(config) != 1:
        raise ValueError(f"algorithm config must have exactly one key, got {config}")
    (name, kwargs), = config.items()
    if name not in algo_registry:
        _load_builtin(name)
    try:
        cls = algo_registry.get(name)
    except KeyError:
        if not _load_plugin(name):
            raise
        cls = algo_registry.get(name)
    return cls(space, **(kwargs or {}))
