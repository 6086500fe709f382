"""Benchmark suite: compare algorithms over standard tasks.

Port of ``metaopt_tpu/benchmark/`` (tasks, assessments, the benchmark
orchestration): the library API for user-defined algorithm comparisons,
and the task registry the batched hunt reads its vectorized objectives
from. Importing it loads no ``torch``; the tasks' ``batch`` forms import it
when called.
"""

from metaopt_tpu_torch.benchmark.assessments import (
    Assessment,
    AverageRank,
    AverageResult,
    Hypervolume,
    ParallelAssessment,
    hypervolume_2d,
)
from metaopt_tpu_torch.benchmark.benchmark import Benchmark, Study
from metaopt_tpu_torch.benchmark.tasks import (
    BenchmarkTask,
    Branin,
    ZDT1,
    Rastrigin,
    RosenBrock,
    Sphere,
    task_registry,
)

__all__ = [
    "Assessment",
    "AverageRank",
    "AverageResult",
    "Hypervolume",
    "ParallelAssessment",
    "hypervolume_2d",
    "Benchmark",
    "BenchmarkTask",
    "Branin",
    "Rastrigin",
    "RosenBrock",
    "Sphere",
    "ZDT1",
    "Study",
    "task_registry",
]
