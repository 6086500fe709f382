"""Executor contract (port of ``metaopt_tpu/executor/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from metaopt_tpu_torch.ledger.trial import Trial

#: periodic callback while a trial runs; returning False means the worker
#: lost its reservation and the executor should abort the trial.
HeartbeatFn = Callable[[], bool]

#: early-stop hook: given the partial-results stream, return {"stop": True}
#: to prune the running trial.
JudgeFn = Callable[[Trial, List[Dict[str, Any]]], Optional[Dict[str, Any]]]


@dataclass
class ExecutionResult:
    status: str                                   # completed | broken | interrupted
    results: List[Dict[str, Any]] = field(default_factory=list)
    exit_code: Optional[int] = None
    note: str = ""


class Executor:
    """Runs one reserved trial to completion."""

    def execute(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        raise NotImplementedError

    def close(self) -> None:
        pass
