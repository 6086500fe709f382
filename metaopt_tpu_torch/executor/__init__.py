"""Trial executors (port of ``metaopt_tpu.executor``): in-process,
subprocess, and subprocess pinned to GPUs (the reference's TPU executor).

The batched executor is not ported yet.
"""

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor
from metaopt_tpu_torch.executor.gpu import GPUExecutor
from metaopt_tpu_torch.executor.inprocess import InProcessExecutor
from metaopt_tpu_torch.executor.subproc import SubprocessExecutor

__all__ = ["ExecutionResult", "Executor", "GPUExecutor", "InProcessExecutor",
           "SubprocessExecutor"]
