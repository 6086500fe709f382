"""The worker loop (port of ``metaopt_tpu.worker``): the producers and
workon."""

from metaopt_tpu_torch.worker.producer import Producer, RemoteProducer
from metaopt_tpu_torch.worker.loop import WorkerStats, workon

__all__ = ["Producer", "RemoteProducer", "WorkerStats", "workon"]
