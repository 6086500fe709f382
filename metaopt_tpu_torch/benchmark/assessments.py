"""Benchmark assessments: how algorithm comparisons are scored.

Port of ``metaopt_tpu/benchmark/assessments.py``. An assessment consumes the
per-repetition regret series the Benchmark collected and produces a
JSON-able analysis table. Pure Python.
"""

from __future__ import annotations

from typing import Any, Dict, List


class Assessment:
    """Turns {algorithm: [series per repetition]} into an analysis dict.

    A series is one float per completed-trial index (one list per
    repetition). What that float *is* belongs to the assessment:
    best-so-far objective by default (:meth:`series`), hypervolume-so-far
    for :class:`Hypervolume`.
    """

    #: how many independent repetitions the benchmark should run
    repetitions: int = 1

    def series(self, ledger, exp_name: str, task=None) -> List[float]:
        """Extract one repetition's progress series from the ledger."""
        from metaopt_tpu_torch.io.webapi import regret_series

        return [p["best"] for p in regret_series(ledger, exp_name)]

    def analyze(
        self, series: Dict[str, List[List[float]]]
    ) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    @property
    def configuration(self) -> Dict[str, Any]:
        return {self.name: {"repetitions": self.repetitions}}


def _mean_curves(runs: List[List[float]]) -> List[float]:
    """Element-wise mean over repetitions, up to the shortest run."""
    if not runs:
        return []
    n = min(len(r) for r in runs)
    return [sum(r[i] for r in runs) / len(runs) for i in range(n)]


class AverageResult(Assessment):
    """Mean best-so-far objective per trial index, per algorithm."""

    def __init__(self, repetitions: int = 3):
        self.repetitions = int(repetitions)

    def analyze(self, series):
        curves = {algo: _mean_curves(runs) for algo, runs in series.items()}
        final = {
            algo: (curve[-1] if curve else None)
            for algo, curve in curves.items()
        }
        ranked = sorted(
            (a for a, v in final.items() if v is not None), key=final.get
        )
        return {
            "assessment": "averageresult",
            "repetitions": self.repetitions,
            "curves": curves,
            "final_best": final,
            "winner": ranked[0] if ranked else None,
        }


def hypervolume_2d(points: List[List[float]],
                   reference: List[float]) -> float:
    """Exact 2-D hypervolume dominated by ``points`` w.r.t. ``reference``.

    Both objectives minimized; points at or beyond the reference
    contribute nothing. O(n log n): sort the nondominated set by f1 and
    sum the staircase slabs.
    """
    r1, r2 = float(reference[0]), float(reference[1])
    pts = sorted((float(p[0]), float(p[1])) for p in points
                 if p[0] < r1 and p[1] < r2)
    hv = 0.0
    best_f2 = r2  # f2 level of the staircase so far
    for f1, f2 in pts:  # ascending f1: only improving f2 adds area
        if f2 < best_f2:
            hv += (r1 - f1) * (best_f2 - f2)
            best_f2 = f2
    return hv


class Hypervolume(Assessment):
    """Mean hypervolume-so-far per trial index (multi-objective studies).

    The series value at index i is the hypervolume of the nondominated
    set of the first i+1 completed trials, w.r.t. a fixed reference
    point — the task's declared ``reference_point`` (so every algorithm
    in a study is scored against the same box) unless one is given here.
    HIGHER is better; `winner` is the argmax of the final mean HV.
    Exact 2-D computation; tasks with more objectives are scored on
    their first two.
    """

    def __init__(self, repetitions: int = 3,
                 reference_point: List[float] = None):
        self.repetitions = int(repetitions)
        self.reference_point = reference_point
        #: the box actually used (task-declared when ours is None) —
        #: recorded so the report never claims "reference_point": null
        #: for numbers that are meaningless without it
        self._resolved_reference: List[float] = reference_point

    def resolve_reference(self, task=None) -> List[float]:
        ref = self.reference_point
        if ref is None:
            ref = getattr(task, "reference_point", None)
        if ref is None:
            raise ValueError(
                "Hypervolume needs a reference_point (on the assessment "
                f"or the task; {getattr(task, 'name', task)!r} declares "
                "none)"
            )
        return list(ref)

    def series(self, ledger, exp_name: str, task=None) -> List[float]:
        from metaopt_tpu_torch.io.webapi import completed_in_order

        ref = self.resolve_reference(task)
        self._resolved_reference = ref
        out, pts = [], []
        for t in completed_in_order(ledger, exp_name):
            if len(t.objectives) < 2:
                continue
            pts.append(t.objectives[:2])
            out.append(hypervolume_2d(pts, ref))
        return out

    def analyze(self, series):
        curves = {algo: _mean_curves(runs) for algo, runs in series.items()}
        final = {algo: (curve[-1] if curve else None)
                 for algo, curve in curves.items()}
        ranked = sorted((a for a, v in final.items() if v is not None),
                        key=final.get, reverse=True)  # higher HV wins
        return {
            "assessment": "hypervolume",
            "repetitions": self.repetitions,
            "reference_point": self._resolved_reference,
            "curves": curves,
            "final_hypervolume": final,
            "winner": ranked[0] if ranked else None,
        }

    @property
    def configuration(self):
        return {self.name: {"repetitions": self.repetitions,
                            "reference_point": self.reference_point}}


class ParallelAssessment(Assessment):
    """How an algorithm holds up when N workers race one experiment.

    ref: the lineage's ParallelAssessment — same trial budget, executed by
    1 vs N concurrent workers against one shared ledger. Two questions:

    - **quality**: asynchronous suggestion means later points are chosen
      with stale observations (suggest happens while N−1 evaluations are
      still in flight) — how much final regret does that cost?
    - **throughput**: wall-clock speedup (and efficiency = speedup/N)
      from the coordination plane. With in-process numpy tasks the GIL
      bounds raw speedup; the number is still the honest cost of the
      reserve/observe contention the workers actually experience.

    The Benchmark runs each (algorithm, repetition) once per entry in
    ``worker_counts``, recording series under ``algo@wN`` keys and wall
    times alongside.
    """

    wants_walls = True

    def __init__(self, repetitions: int = 2,
                 worker_counts: List[int] = (1, 4)):
        self.repetitions = int(repetitions)
        # dedup: a repeated count would rebuild the SAME experiment name,
        # join the finished run, and record a ~0s wall that fakes speedup
        self.worker_counts = sorted({int(n) for n in worker_counts})
        if any(n < 1 for n in self.worker_counts):
            raise ValueError("worker_counts must be >= 1")

    @staticmethod
    def _split(key: str):
        algo, _, w = key.rpartition("@w")
        return algo, int(w)

    def analyze(self, series, walls=None):
        walls = walls or {}
        per_algo: Dict[str, Dict[int, Dict[str, Any]]] = {}
        for key, runs in series.items():
            algo, nw = self._split(key)
            curves = _mean_curves(runs)
            wall_list = walls.get(key) or []
            per_algo.setdefault(algo, {})[nw] = {
                "final_best": curves[-1] if curves else None,
                "mean_wall_s": (round(sum(wall_list) / len(wall_list), 3)
                                if wall_list else None),
            }
        table: Dict[str, Any] = {}
        for algo, by_n in per_algo.items():
            base = by_n.get(1) or {}
            rows = {}
            for nw in sorted(by_n):
                row = dict(by_n[nw])
                if nw != 1 and base.get("mean_wall_s") and row["mean_wall_s"]:
                    sp = base["mean_wall_s"] / row["mean_wall_s"]
                    row["speedup_vs_1w"] = round(sp, 2)
                    row["efficiency"] = round(sp / nw, 2)
                if nw != 1 and base.get("final_best") is not None \
                        and row["final_best"] is not None:
                    row["regret_penalty_vs_1w"] = (
                        row["final_best"] - base["final_best"]
                    )
                rows[f"w{nw}"] = row
            table[algo] = rows
        top_n = max(self.worker_counts)
        finals = {
            a: rows.get(f"w{top_n}", {}).get("final_best")
            for a, rows in table.items()
        }
        ranked = sorted((a for a, v in finals.items() if v is not None),
                        key=finals.get)
        return {
            "assessment": "parallelassessment",
            "repetitions": self.repetitions,
            "worker_counts": self.worker_counts,
            "algorithms": table,
            "winner": ranked[0] if ranked else None,
        }

    @property
    def configuration(self):
        return {self.name: {"repetitions": self.repetitions,
                            "worker_counts": self.worker_counts}}


class AverageRank(Assessment):
    """Mean rank (1 = best) of each algorithm across repetitions.

    Ranks are computed per repetition on the final best objective, so an
    algorithm that wins most seeds ranks near 1 even if another wins big
    on one lucky seed.
    """

    def __init__(self, repetitions: int = 3):
        self.repetitions = int(repetitions)

    def analyze(self, series):
        algos = [a for a, runs in series.items() if runs]
        if not algos:
            return {"assessment": "averagerank", "ranks": {}, "winner": None}
        reps = min(len(series[a]) for a in algos)
        totals = {a: 0.0 for a in algos}
        for rep in range(reps):
            finals = {a: series[a][rep][-1] for a in algos if series[a][rep]}
            order = sorted(finals, key=finals.get)
            for rank, a in enumerate(order, start=1):
                totals[a] += rank
            for a in algos:  # no completed trials this rep = worst rank
                if a not in finals:
                    totals[a] += len(algos)
        ranks = {a: (totals[a] / reps if reps else None) for a in algos}
        ranked = sorted(ranks, key=ranks.get)
        return {
            "assessment": "averagerank",
            "repetitions": reps,
            "ranks": ranks,
            "winner": ranked[0] if ranked else None,
        }
