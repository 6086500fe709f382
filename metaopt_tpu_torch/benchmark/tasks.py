"""Benchmark tasks: standard black-box objectives with declared spaces.

Port of ``metaopt_tpu/benchmark/tasks.py``. Each task is a callable
objective plus a search-space declaration and a trial budget, so a
:class:`~metaopt_tpu_torch.benchmark.Benchmark` can run algorithm
comparisons without any user script. The functions are the classic public
test objectives (Rosenbrock, Branin, Sphere, Rastrigin, and the
bi-objective ZDT1). The scalar ``__call__`` forms are pure Python, the
reference's to the last bit.

The four classics also expose a ``batch(cols)`` vectorized variant —
``torch`` over ``(B,)`` float32 columns (the :meth:`Space.stack_points`
layout, or a ``(B, d)`` matrix), on the device the columns lie on — so a
:class:`~metaopt_tpu_torch.executor.BatchedExecutor` evaluates an entire
suggestion pool in one call. ``torch`` is imported inside ``batch``: the
module loads without it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

from metaopt_tpu_torch.models.objectives import f32_column
from metaopt_tpu_torch.utils.registry import Registry

task_registry: Registry = Registry("benchmark task")


class BenchmarkTask:
    """A self-contained objective: space spec + budget + callable."""

    def __init__(self, max_trials: int = 20):
        self.max_trials = int(max_trials)

    @property
    def space(self) -> Dict[str, str]:
        raise NotImplementedError

    def __call__(self, params: Dict[str, Any]) -> List[Dict[str, Any]]:
        raise NotImplementedError

    @property
    def vectorized(self) -> bool:
        """True when this task overrides ``batch`` with a torch column form."""
        return type(self).batch is not BenchmarkTask.batch

    def batch(self, cols):
        """Vectorized objective: ``(B,)`` columns → ``(B,)`` values."""
        raise NotImplementedError(f"{self.name} has no vectorized form")

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    @property
    def configuration(self) -> Dict[str, Any]:
        return {self.name: {"max_trials": self.max_trials}}


def _objective(value: float) -> List[Dict[str, Any]]:
    return [{"name": "objective", "type": "objective", "value": float(value)}]


def _columns(cols, names):
    """Normalize a stacked pool — ``{name: (B,)}`` dict or ``(B, d)``
    matrix — into the named column list a batch objective closes over.
    Cast to float32 before any arithmetic, as the reference does: float64
    arithmetic would drift from it by more than f32 rounding."""
    if isinstance(cols, Mapping):
        return [f32_column(cols[n]) for n in names]
    mat = f32_column(cols)
    if mat.ndim != 2 or mat.shape[1] != len(names):
        raise ValueError(
            f"expected (B, {len(names)}) matrix or column dict, got {tuple(mat.shape)}"
        )
    return [mat[:, i] for i in range(len(names))]


@task_registry.register("rosenbrock")
class RosenBrock(BenchmarkTask):
    """f(x) = Σ 100(x_{i+1} − x_i²)² + (1 − x_i)²; minimum 0 at x=1."""

    def __init__(self, max_trials: int = 30, dim: int = 2):
        super().__init__(max_trials)
        self.dim = int(dim)

    @property
    def space(self) -> Dict[str, str]:
        return {f"x{i}": "uniform(-5, 10)" for i in range(self.dim)}

    def __call__(self, params):
        x = [params[f"x{i}"] for i in range(self.dim)]
        return _objective(sum(
            100.0 * (x[i + 1] - x[i] ** 2) ** 2 + (1.0 - x[i]) ** 2
            for i in range(self.dim - 1)
        ))

    def batch(self, cols):
        x = _columns(cols, [f"x{i}" for i in range(self.dim)])
        return sum(
            100.0 * (x[i + 1] - x[i] ** 2) ** 2 + (1.0 - x[i]) ** 2
            for i in range(self.dim - 1)
        )

    @property
    def configuration(self):
        return {self.name: {"max_trials": self.max_trials, "dim": self.dim}}


@task_registry.register("branin")
class Branin(BenchmarkTask):
    """The 2-D Branin-Hoo function; global minimum ≈ 0.397887."""

    @property
    def space(self) -> Dict[str, str]:
        return {"x0": "uniform(-5, 10)", "x1": "uniform(0, 15)"}

    def __call__(self, params):
        x0, x1 = params["x0"], params["x1"]
        b = 5.1 / (4 * math.pi ** 2)
        c = 5.0 / math.pi
        s = 10.0
        t = 1.0 / (8 * math.pi)
        return _objective(
            (x1 - b * x0 ** 2 + c * x0 - 6.0) ** 2
            + s * (1 - t) * math.cos(x0) + s
        )

    def batch(self, cols):
        import torch

        x0, x1 = _columns(cols, ["x0", "x1"])
        b = 5.1 / (4 * math.pi ** 2)
        c = 5.0 / math.pi
        s = 10.0
        t = 1.0 / (8 * math.pi)
        return (
            (x1 - b * x0 ** 2 + c * x0 - 6.0) ** 2
            + s * (1 - t) * torch.cos(x0) + s
        )


@task_registry.register("sphere")
class Sphere(BenchmarkTask):
    """f(x) = Σ x_i²; minimum 0 at the origin."""

    def __init__(self, max_trials: int = 20, dim: int = 2):
        super().__init__(max_trials)
        self.dim = int(dim)

    @property
    def space(self) -> Dict[str, str]:
        return {f"x{i}": "uniform(-5.12, 5.12)" for i in range(self.dim)}

    def __call__(self, params):
        return _objective(sum(
            params[f"x{i}"] ** 2 for i in range(self.dim)
        ))

    def batch(self, cols):
        x = _columns(cols, [f"x{i}" for i in range(self.dim)])
        return sum(c ** 2 for c in x)

    @property
    def configuration(self):
        return {self.name: {"max_trials": self.max_trials, "dim": self.dim}}


@task_registry.register("zdt1")
class ZDT1(BenchmarkTask):
    """The classic bi-objective ZDT1 trade-off (both minimized).

    f1 = x0; g = 1 + 9·mean(x1..x_{d−1}); f2 = g·(1 − √(f1/g)).
    The Pareto set is x1..x_{d−1} = 0 with x0 sweeping [0, 1]; the true
    front is f2 = 1 − √f1. ``reference_point`` bounds the attainable
    region (f1 ≤ 1, f2 ≤ 10 at d=2) so hypervolume is comparable across
    algorithms.
    """

    #: fixed box for the Hypervolume assessment
    reference_point = [1.0, 10.0]

    def __init__(self, max_trials: int = 40, dim: int = 2):
        super().__init__(max_trials)
        self.dim = int(dim)

    @property
    def space(self) -> Dict[str, str]:
        return {f"x{i}": "uniform(0, 1)" for i in range(self.dim)}

    def __call__(self, params):
        f1 = float(params["x0"])
        tail = [params[f"x{i}"] for i in range(1, self.dim)]
        g = 1.0 + 9.0 * (sum(tail) / len(tail) if tail else 0.0)
        f2 = g * (1.0 - math.sqrt(max(f1, 0.0) / g))
        return [
            {"name": "f1", "type": "objective", "value": f1},
            {"name": "f2", "type": "objective", "value": f2},
        ]

    @property
    def configuration(self):
        return {self.name: {"max_trials": self.max_trials, "dim": self.dim}}


@task_registry.register("rastrigin")
class Rastrigin(BenchmarkTask):
    """f(x) = 10d + Σ (x_i² − 10 cos 2πx_i); highly multimodal, min 0."""

    def __init__(self, max_trials: int = 30, dim: int = 2):
        super().__init__(max_trials)
        self.dim = int(dim)

    @property
    def space(self) -> Dict[str, str]:
        return {f"x{i}": "uniform(-5.12, 5.12)" for i in range(self.dim)}

    def __call__(self, params):
        return _objective(10.0 * self.dim + sum(
            params[f"x{i}"] ** 2
            - 10.0 * math.cos(2 * math.pi * params[f"x{i}"])
            for i in range(self.dim)
        ))

    def batch(self, cols):
        import torch

        x = _columns(cols, [f"x{i}" for i in range(self.dim)])
        return 10.0 * self.dim + sum(
            c ** 2 - 10.0 * torch.cos(2 * math.pi * c) for c in x
        )

    @property
    def configuration(self):
        return {self.name: {"max_trials": self.max_trials, "dim": self.dim}}
