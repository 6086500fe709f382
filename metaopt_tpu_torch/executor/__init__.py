"""Trial executors (port of ``metaopt_tpu.executor``): in-process and
subprocess.

The batched and chip-placing executors are not ported yet.
"""

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor
from metaopt_tpu_torch.executor.inprocess import InProcessExecutor
from metaopt_tpu_torch.executor.subproc import SubprocessExecutor

__all__ = ["ExecutionResult", "Executor", "InProcessExecutor", "SubprocessExecutor"]
