"""Meshes, sharding and collectives for a trial's ranks (port of
``metaopt_tpu/parallel``).

A trial handed a block of GPUs (``MTPU_ASSIGNED_CHIPS``) runs one rank per
GPU (:mod:`~metaopt_tpu_torch.parallel.launch`) over a
``torch.distributed`` process group, and its model shards over them:

- :func:`trial_devices` — the devices this trial may use,
- :func:`make_mesh` / :func:`trial_mesh` — dp/tp (or custom) meshes,
- :func:`shard_batch` / :func:`replicate` / :func:`shard_params` — each
  rank's slice of a batch and of the parameters,
- :func:`pod_agree` / :func:`run_signaled` — stop decisions every rank
  agrees on,
- :mod:`~metaopt_tpu_torch.parallel.collectives` and
  :mod:`~metaopt_tpu_torch.parallel.pipeline` — collectives with
  gradients and the pipeline schedules.
"""

from metaopt_tpu_torch.parallel.control import pod_agree, run_signaled
from metaopt_tpu_torch.parallel.mesh import make_mesh, trial_devices, trial_mesh
from metaopt_tpu_torch.parallel.sharding import (
    batch_spec,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "trial_devices",
    "make_mesh",
    "trial_mesh",
    "shard_batch",
    "replicate",
    "batch_spec",
    "shard_params",
    "pod_agree",
    "run_signaled",
]
