"""In-process executor: the objective is a Python callable.

Port of ``metaopt_tpu/executor/inprocess.py``: library-style use where the
objective is Python/PyTorch in this process. The callable may return a float (treated as the objective) or a
full list of typed result dicts.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor, HeartbeatFn, JudgeFn
from metaopt_tpu_torch.ledger.trial import Trial

ObjectiveFn = Callable[[Dict[str, Any]], Union[float, List[Dict[str, Any]]]]


class InProcessExecutor(Executor):
    def __init__(self, fn: ObjectiveFn):
        self.fn = fn

    def execute(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        if heartbeat is not None and not heartbeat():
            return ExecutionResult("interrupted", note="lost reservation")
        try:
            out = self.fn(dict(trial.params))
        except KeyboardInterrupt:
            raise
        except Exception as e:  # a broken trial must not kill the worker
            return ExecutionResult("broken", note=f"{type(e).__name__}: {e}")
        if isinstance(out, (int, float)):
            results = [{"name": "objective", "type": "objective", "value": float(out)}]
        else:
            results = [dict(r) for r in out]
        # re-check after evaluation: a reservation lost *while* fn ran means
        # the sweeper already reassigned this trial — completing it now
        # would stomp the other worker's run with a stale result.
        if heartbeat is not None and not heartbeat():
            return ExecutionResult(
                "interrupted", note="lost reservation during evaluation"
            )
        return ExecutionResult("completed", results=results, exit_code=0)
