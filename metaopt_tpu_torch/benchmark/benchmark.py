"""The Benchmark orchestrator: algorithms × tasks × assessments.

Port of ``metaopt_tpu/benchmark/benchmark.py``. A benchmark is a named
bundle of *studies* (assessment + task), processed over a list of
algorithm configurations; each (algorithm, task, repetition) is a real
Experiment on the ledger driven by ``workon`` with the in-process
executor, so the benchmark exercises exactly the code path users run. An
algorithm with device work (TPE, GP-BO, MOTPE) runs on ``cuda`` unless its
configuration names another ``device``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from metaopt_tpu_torch.benchmark.assessments import Assessment
from metaopt_tpu_torch.benchmark.tasks import BenchmarkTask
from metaopt_tpu_torch.executor import InProcessExecutor
from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
from metaopt_tpu_torch.ledger.backends import LedgerBackend
from metaopt_tpu_torch.worker import workon

log = logging.getLogger(__name__)

AlgoSpec = Union[str, Dict[str, Any]]


def _algo_config(spec: AlgoSpec) -> Tuple[str, Dict[str, Any]]:
    if isinstance(spec, str):
        return spec, {}
    (name, kwargs), = spec.items()
    return name, dict(kwargs or {})


class Study:
    """One assessment applied to one task across all algorithms."""

    def __init__(self, assessment: Assessment, task: BenchmarkTask):
        self.assessment = assessment
        self.task = task
        #: series key -> list (one per repetition) of regret series. The
        #: key is the algorithm name — suffixed ``@wN`` when the
        #: assessment runs multiple worker counts (ParallelAssessment)
        self.series: Dict[str, List[List[float]]] = {}
        #: series key -> wall-clock seconds per repetition
        self.walls: Dict[str, List[float]] = {}

    def record(self, key: str, series: List[float],
               wall_s: Optional[float] = None) -> None:
        self.series.setdefault(key, []).append(series)
        if wall_s is not None:
            self.walls.setdefault(key, []).append(wall_s)

    def analyze(self) -> Dict[str, Any]:
        extra = (
            {"walls": self.walls}
            if getattr(self.assessment, "wants_walls", False) else {}
        )
        return {
            "task": self.task.name,
            "task_config": self.task.configuration,
            **self.assessment.analyze(self.series, **extra),
        }


class Benchmark:
    """Compare algorithms over task/assessment studies.

    >>> bench = Benchmark(
    ...     "demo",
    ...     algorithms=["random", {"tpe": {"n_initial": 5}}],
    ...     targets=[{"assess": [AverageResult(3)], "task": [RosenBrock(25)]}],
    ... )
    >>> bench.process()
    >>> bench.analysis()
    """

    def __init__(
        self,
        name: str,
        algorithms: Sequence[AlgoSpec],
        targets: Sequence[Dict[str, Sequence[Any]]],
        ledger: Optional[LedgerBackend] = None,
    ):
        self.name = name
        self.algorithms = list(algorithms)
        self.ledger = ledger if ledger is not None else MemoryLedger()
        self.studies: List[Study] = []
        for target in targets:
            for assessment in target["assess"]:
                for task in target["task"]:
                    self.studies.append(Study(assessment, task))
        self._processed = False

    # -- execution ---------------------------------------------------------
    def _run_one(
        self, study: Study, algo_name: str, algo_kwargs: Dict[str, Any],
        repetition: int, n_workers: int = 1,
    ) -> Tuple[List[float], float]:
        from metaopt_tpu_torch.space import build_space

        exp_name = (
            f"{self.name}-{study.task.name}-{study.assessment.name}-"
            f"{algo_name}-rep{repetition}"
        )
        if n_workers != 1:
            exp_name += f"-w{n_workers}"
        kwargs = dict(algo_kwargs)
        kwargs.setdefault("seed", repetition)
        exp = Experiment(
            exp_name,
            self.ledger,
            space=build_space(study.task.space),
            algorithm={algo_name: kwargs},
            max_trials=study.task.max_trials,
            pool_size=1,
            metadata={"benchmark": self.name},
        ).configure()
        t0 = time.perf_counter()
        if n_workers == 1:
            workon(exp, InProcessExecutor(study.task), worker_id=exp_name)
        else:
            # N full workon loops racing one shared ledger — the same
            # async-suggestion semantics as `hunt --n-workers` (each loop
            # has its own Experiment handle; the reserve CAS arbitrates).
            # Deliberately simpler than the CLI's thread loop
            # (cli/main.py::_cmd_hunt): in-process tasks need no
            # stop_event wind-down, per-thread executors, or coord
            # socket handling
            import threading

            errors: Dict[int, str] = {}

            def run(i: int) -> None:
                try:
                    w_exp = Experiment(exp_name, self.ledger).configure()
                    workon(w_exp, InProcessExecutor(study.task),
                           worker_id=f"{exp_name}-w{i}")
                except BaseException as err:  # must surface, not vanish
                    errors[i] = f"{type(err).__name__}: {err}"

            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise RuntimeError(
                    f"benchmark worker(s) died: {errors}"
                )
        wall_s = time.perf_counter() - t0
        # the assessment owns what "progress" means: best-so-far objective
        # by default, hypervolume-so-far for multi-objective studies
        return (
            study.assessment.series(self.ledger, exp_name, task=study.task),
            wall_s,
        )

    def process(self) -> None:
        """Run every (study × algorithm × repetition [× workers]) run."""
        t0 = time.perf_counter()
        for study in self.studies:
            raw = getattr(study.assessment, "worker_counts", None)
            counts = raw or [1]
            # an assessment that DECLARES worker counts always gets @wN
            # keys (its analyze parses them), even for worker_counts=[1]
            multi = raw is not None
            for spec in self.algorithms:
                algo_name, algo_kwargs = _algo_config(spec)
                for rep in range(study.assessment.repetitions):
                    for nw in counts:
                        series, wall_s = self._run_one(
                            study, algo_name, algo_kwargs, rep, nw
                        )
                        key = (f"{algo_name}@w{nw}" if multi else algo_name)
                        study.record(key, series, wall_s=wall_s)
                        log.info(
                            "benchmark %s: %s/%s/%s rep %d w%d -> best %s "
                            "(%.1fs)",
                            self.name, study.task.name,
                            study.assessment.name, algo_name, rep, nw,
                            series[-1] if series else None, wall_s,
                        )
        self._processed = True
        log.info("benchmark %s processed in %.1fs",
                 self.name, time.perf_counter() - t0)

    # -- results -----------------------------------------------------------
    def analysis(self) -> List[Dict[str, Any]]:
        if not self._processed:
            raise RuntimeError("call process() before analysis()")
        return [s.analyze() for s in self.studies]

    @property
    def configuration(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "algorithms": self.algorithms,
            "studies": [
                {"task": s.task.configuration,
                 "assessment": s.assessment.configuration}
                for s in self.studies
            ],
        }
