"""The trial ledger (port of ``metaopt_tpu.ledger``).

Register / reserve (CAS) / update / fetch over a :class:`LedgerBackend`:
:class:`MemoryLedger` (completed trials sealed into the columnar archive),
:class:`FileLedger` and ``NativeFileLedger`` (the C++ ledgerstore engine,
``ledger.native``; both keep the reference's on-disk layout), and EVC
branching (:class:`TrialAdapter`).
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
from metaopt_tpu_torch.ledger.evc import BranchConflictError, TrialAdapter

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
    "TrialAdapter",
    "BranchConflictError",
]
