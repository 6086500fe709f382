"""The worker loop (port of ``metaopt_tpu.worker``): Producer and workon."""

from metaopt_tpu_torch.worker.producer import Producer
from metaopt_tpu_torch.worker.loop import WorkerStats, workon

__all__ = ["Producer", "WorkerStats", "workon"]
