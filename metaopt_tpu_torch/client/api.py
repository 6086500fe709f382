"""The Python-API flow: ``build_experiment(...).workon(fn)``.

Port of ``metaopt_tpu/client/api.py``: the client wraps a ledger-backed
:class:`~metaopt_tpu_torch.ledger.experiment.Experiment`, runs ``workon``
with the in-process executor, and shares the Producer (observe → suggest →
dedup → register) with the manual ``suggest()``/``observe()`` loop.
``to_pandas`` needs pandas (imported at its call; it raises ImportError
without it); ``pareto_front`` shares MOTPE's ranking.

>>> from metaopt_tpu_torch import build_experiment
>>> exp = build_experiment(
...     "demo", space={"x": "uniform(-5, 5)"},
...     algorithm={"random": {"seed": 1}}, max_trials=40)
>>> exp.workon(lambda params: (params["x"] - 1) ** 2)  # doctest: +SKIP
>>> exp.best.objective  # doctest: +SKIP
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from metaopt_tpu_torch.ledger.backends import LedgerBackend, ledger_from_spec
from metaopt_tpu_torch.ledger.experiment import Experiment
from metaopt_tpu_torch.ledger.trial import Trial


class WaitingForTrials(RuntimeError):
    """suggest(): nothing reservable right now, but the search isn't done.

    Other workers hold the in-flight trials, or the algorithm is at a
    barrier (sync rungs / a generation cohort waiting on stragglers).
    Retry after those complete — or pass ``block=True``.
    """


class CompletedExperiment(RuntimeError):
    """suggest() on an experiment that is already done."""


class ExperimentClient:
    """Library handle over one experiment: run, steer, inspect."""

    def __init__(self, experiment: Experiment, worker_id: str = "api-0"):
        self._exp = experiment
        self._worker = worker_id
        self._producer = None  # built lazily; shares one algorithm fit

    # -- the one-call flow -------------------------------------------------
    def workon(self, fn, max_trials: Optional[int] = None, **kw):
        """Evaluate ``fn(params)`` until the experiment is done.

        ``fn`` may return a scalar objective or a full results list (the
        ``report_results`` schema — several objective entries for
        multi-objective searches). Extra ``**kw`` pass through to
        :func:`metaopt_tpu_torch.worker.workon` (``worker_trials``,
        ``max_broken``, ...).
        """
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.worker import workon as _workon

        if max_trials is not None:
            kw.setdefault("worker_trials", max_trials)
        return _workon(self._exp, InProcessExecutor(fn),
                       worker_id=self._worker, **kw)

    # -- the manual loop ---------------------------------------------------
    def _ensure_producer(self):
        if self._producer is None:
            from metaopt_tpu_torch.algo import make_algorithm
            from metaopt_tpu_torch.worker.producer import Producer

            algo = make_algorithm(self._exp.space, self._exp.algorithm)
            self._producer = Producer(self._exp, algo)
        return self._producer

    def suggest(self, block: bool = False, timeout_s: float = 60.0,
                poll_s: float = 0.25,
                heartbeat_timeout_s: float = 60.0) -> Trial:
        """Reserve the next trial to evaluate (producing when needed).

        Raises :class:`CompletedExperiment` when the search is done and
        :class:`WaitingForTrials` when everything runnable is in flight
        elsewhere (unless ``block=True``, which polls up to
        ``timeout_s``). Each attempt also re-frees reservations whose
        heartbeat lapsed past ``heartbeat_timeout_s`` — the pacemaker
        sweep the worker loop runs every cycle; without it an API-only
        deployment would never recover a crashed client's trial.
        """
        deadline = time.time() + timeout_s
        while True:
            if self._exp.is_done:
                raise CompletedExperiment(
                    f"experiment {self._exp.name!r} is done"
                )
            self._exp.ledger.release_stale(self._exp.name,
                                           heartbeat_timeout_s)
            self._ensure_producer().produce()
            trial = self._exp.reserve_trial(self._worker)
            if trial is not None:
                return trial
            if not block:
                raise WaitingForTrials(
                    f"experiment {self._exp.name!r}: nothing reservable "
                    "(in-flight trials elsewhere or an algorithm barrier)"
                )
            if time.time() >= deadline:
                raise WaitingForTrials(
                    f"experiment {self._exp.name!r}: still nothing "
                    f"reservable after {timeout_s:.0f}s"
                )
            time.sleep(poll_s)

    def observe(
        self,
        trial: Trial,
        results: Union[float, int, Sequence[Dict[str, Any]]],
    ) -> None:
        """Complete a suggested trial with its measurement.

        ``results``: a scalar objective, or the ``report_results``-schema
        list (which may carry several objective entries, constraints,
        gradients, statistics). The schema's at-least-one-objective rule
        is enforced here too — an objective-less "completion" would
        silently burn max_trials budget while every algorithm skips it.

        Raises RuntimeError if the reservation was lost meanwhile (e.g.
        the evaluation outlived the heartbeat timeout and a pacemaker
        re-freed the trial) — the measurement did NOT reach the ledger.
        """
        if isinstance(results, (int, float)):
            results = [{"name": "objective", "type": "objective",
                        "value": float(results)}]
        results = [dict(r) for r in results]
        if not any(r.get("type") == "objective" for r in results):
            raise ValueError(
                "observe() needs at least one objective-typed result "
                f"(got types {[r.get('type') for r in results]})"
            )
        if not self._exp.push_results(trial, results):
            raise RuntimeError(
                f"trial {trial.id}: reservation lost before results "
                "landed (evaluation outlived the heartbeat timeout?) — "
                "the measurement was NOT recorded"
            )

    def release(self, trial: Trial, status: str = "new") -> None:
        """Give back a suggested trial without results.

        Default ``status="new"`` RE-QUEUES it (any worker can reserve it
        again — same mechanics as the stale-reservation pacemaker);
        ``"interrupted"``/``"broken"`` abandon it permanently instead.
        """
        if status == "new":
            trial.status = "new"  # reserved→new bypasses the lifecycle
            trial.worker = None   # table by design, like release_stale
            trial.start_time = None
            trial.heartbeat = None
            self._exp.ledger.update_trial(
                trial, expected_status="reserved",
                expected_worker=self._worker,
            )
            return
        trial.transition(status)
        self._exp.ledger.update_trial(
            trial, expected_status="reserved", expected_worker=self._worker
        )

    # -- inspection --------------------------------------------------------
    @property
    def name(self) -> str:
        return self._exp.name

    @property
    def space(self):
        return self._exp.space

    @property
    def is_done(self) -> bool:
        return self._exp.is_done

    @property
    def experiment(self) -> Experiment:
        """The underlying ledger-backed experiment (full API)."""
        return self._exp

    @property
    def stats(self) -> Dict[str, Any]:
        return self._exp.stats

    @property
    def best(self) -> Optional[Trial]:
        """The completed trial with the lowest (first) objective."""
        done = [t for t in self._exp.fetch_completed_trials()
                if t.objective is not None]
        return min(done, key=lambda t: t.objective) if done else None

    def fetch_trials(self, status: Optional[str] = None) -> List[Trial]:
        return self._exp.ledger.fetch(self._exp.name, status)

    def to_pandas(self, with_evc_tree: bool = False):
        """The experiment's trials as a DataFrame (lineage ``to_pandas``).

        One row per trial: id, status, timing, worker, the objective, and
        the params flattened into ``params.<name>`` columns. With
        ``with_evc_tree`` the frame also includes every ancestor/child
        version's trials (a ``experiment`` column disambiguates), walking
        ``branch_parent`` links both ways the way the lineage's EVC
        fetches do.
        """
        try:
            import pandas as pd
        except ImportError as err:  # the reference's message, word for word
            raise ImportError(
                "ExperimentClient.to_pandas needs pandas "
                "(pip install metaopt-tpu[pandas])"
            ) from err

        from metaopt_tpu_torch.ledger.evc import branch_parent

        ledger = self._exp.ledger
        names = [self._exp.name]
        if with_evc_tree:
            doc = ledger.load_experiment(self._exp.name) or {}
            seen = {self._exp.name}
            parent = branch_parent(doc)
            while parent and parent not in seen:  # ancestors
                seen.add(parent)
                names.insert(0, parent)
                pdoc = ledger.load_experiment(parent) or {}
                parent = branch_parent(pdoc)
            # descendants: parent -> children map first, then expand to a
            # fixpoint — a single sorted pass would drop a grandchild
            # listed before its parent (e.g. fam-v10 < fam-v2)
            children: Dict[str, List[str]] = {}
            for other in ledger.list_experiments():
                if other in seen:
                    continue
                odoc = ledger.load_experiment(other) or {}
                p = branch_parent(odoc)
                if p:
                    children.setdefault(p, []).append(other)
            frontier = list(names)
            while frontier:
                kids = [
                    c for p in frontier for c in sorted(children.get(p, []))
                    if c not in seen
                ]
                seen.update(kids)
                names.extend(kids)
                frontier = kids
        rows = []
        for name in names:
            for t in ledger.fetch(name):
                row = {
                    "experiment": name,
                    "id": t.id,
                    "status": t.status,
                    "worker": t.worker,
                    "submit_time": t.submit_time,
                    "start_time": t.start_time,
                    "end_time": t.end_time,
                    "objective": t.objective,
                }
                for k, v in t.params.items():
                    row[f"params.{k}"] = v
                rows.append(row)
        base_cols = ["experiment", "id", "status", "worker", "submit_time",
                     "start_time", "end_time", "objective"]
        if not rows:  # keep the documented schema even when empty
            return pd.DataFrame(columns=base_cols)
        return pd.DataFrame(rows)

    def pareto_front(self) -> List[Tuple[Dict[str, Any], List[float]]]:
        """Nondominated ``(params, objective_vector)`` pairs (multi-
        objective experiments; ranking shared with motpe / plot pareto)."""
        import numpy as np

        from metaopt_tpu_torch.algo.motpe import nondominated_ranks

        done = [t for t in self._exp.fetch_completed_trials()
                if len(t.objectives) >= 2
                and np.all(np.isfinite(t.objectives))]
        if not done:
            return []
        m = min(len(t.objectives) for t in done)
        F = np.asarray([t.objectives[:m] for t in done])
        ranks = nondominated_ranks(F)
        return [(dict(done[i].params), F[i].tolist())
                for i in np.where(ranks == 0)[0]]


def build_experiment(
    name: str,
    space: Optional[Dict[str, str]] = None,
    algorithm: Optional[Dict[str, Any]] = None,
    max_trials: Optional[int] = None,
    ledger: Union[str, LedgerBackend] = "memory",
    pool_size: int = 1,
    worker_id: str = "api-0",
    **experiment_kw: Any,
) -> ExperimentClient:
    """Create-or-load an experiment and return its client handle.

    ``space`` maps names to ``~prior`` expressions (``{"x": "uniform(-5,
    5)"}``); ``algorithm`` is the one-key config (``{"tpe": {...}}``,
    default random); ``ledger`` is a backend instance or a spec string —
    ``"memory"``, a directory path, ``"native:<dir>"``, ``"file:<dir>"``
    or ``"coord://host:port"`` (the CLI's ``--ledger`` grammar; a
    coordinator's ``workon(fn, producer_mode="coord")`` delegates
    suggestion to its hosted algorithm). Re-calling
    with the same name on the same ledger ADOPTS the stored
    configuration, exactly like re-running ``hunt`` (resume semantics).
    """
    from metaopt_tpu_torch.space import build_space

    backend = (ledger if isinstance(ledger, LedgerBackend)
               else ledger_from_spec(ledger))
    if max_trials is not None:  # None = keep Experiment's default / stored
        experiment_kw["max_trials"] = max_trials
    exp = Experiment(
        name,
        backend,
        space=build_space(space) if space else None,
        algorithm=algorithm,
        pool_size=pool_size,
        **experiment_kw,
    ).configure()
    return ExperimentClient(exp, worker_id=worker_id)
