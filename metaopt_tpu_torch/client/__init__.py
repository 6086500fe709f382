"""The Python API (port of ``metaopt_tpu.client.api``).

The reference's ``client/__init__.py`` also holds the subprocess handshake
(``report_results``) of the subprocess executor, which is not ported yet.
"""

from metaopt_tpu_torch.client.api import (
    CompletedExperiment,
    ExperimentClient,
    WaitingForTrials,
    build_experiment,
)

__all__ = [
    "CompletedExperiment",
    "ExperimentClient",
    "WaitingForTrials",
    "build_experiment",
]
