"""The trial ledger (port of ``metaopt_tpu.ledger``): the in-memory backend.

Register / reserve (CAS) / update / fetch over a :class:`LedgerBackend`;
:class:`MemoryLedger` is the one backend ported so far.
"""

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ledger.backends import (
    DuplicateExperimentError,
    DuplicateTrialError,
    LedgerBackend,
    MemoryLedger,
    ledger_from_spec,
    ledger_registry,
)
from metaopt_tpu_torch.ledger.experiment import Experiment

__all__ = [
    "Trial",
    "DuplicateExperimentError",
    "DuplicateTrialError",
    "LedgerBackend",
    "MemoryLedger",
    "ledger_from_spec",
    "ledger_registry",
    "Experiment",
]
