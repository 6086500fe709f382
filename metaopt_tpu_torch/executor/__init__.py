"""Trial executors (port of ``metaopt_tpu.executor``): the in-process one.

The subprocess, batched and chip-placing executors are not ported yet.
"""

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor
from metaopt_tpu_torch.executor.inprocess import InProcessExecutor

__all__ = ["ExecutionResult", "Executor", "InProcessExecutor"]
