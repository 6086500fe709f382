"""The trial ledger (port of ``metaopt_tpu.ledger``).

Register / reserve (CAS) / update / fetch over a :class:`LedgerBackend`:
:class:`MemoryLedger` and :class:`FileLedger` (the reference's on-disk
layout) are ported.
"""

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ledger.backends import (
    DuplicateExperimentError,
    DuplicateTrialError,
    FileLedger,
    LedgerBackend,
    MemoryLedger,
    ledger_from_spec,
    ledger_registry,
    local_ledger,
    make_ledger,
)
from metaopt_tpu_torch.ledger.experiment import Experiment

__all__ = [
    "Trial",
    "DuplicateExperimentError",
    "DuplicateTrialError",
    "FileLedger",
    "LedgerBackend",
    "MemoryLedger",
    "ledger_from_spec",
    "ledger_registry",
    "local_ledger",
    "make_ledger",
    "Experiment",
]
