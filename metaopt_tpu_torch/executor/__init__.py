"""Trial executors (port of ``metaopt_tpu.executor``): in-process,
subprocess, subprocess pinned to GPUs (the reference's TPU executor), and
batched — a whole pool of trials in one call of a vectorized objective on
the device.
"""

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor
from metaopt_tpu_torch.executor.batched import BatchedExecutor
from metaopt_tpu_torch.executor.gpu import GPUExecutor
from metaopt_tpu_torch.executor.inprocess import InProcessExecutor
from metaopt_tpu_torch.executor.subproc import SubprocessExecutor

__all__ = ["BatchedExecutor", "ExecutionResult", "Executor", "GPUExecutor",
           "InProcessExecutor", "SubprocessExecutor"]
