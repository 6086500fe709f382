"""Batched executor: a whole suggestion pool as one call on the device.

Port of ``metaopt_tpu/executor/batched.py``. For vectorizable spaces
(``Space.vectorizable()``) and vectorized objectives (``benchmark/tasks.py``
``batch`` forms, the ``models/objectives.py`` zoo), an entire pool of
reserved trials stacks into per-dimension columns on the device and
evaluates in a single call of the objective, so population HPO
(EvolutionES / PBT / CMA-ES generations, ASHA rungs) pays one dispatch
per pool instead of one per trial. The reference jits that call into one
XLA program; here it is eager PyTorch on the columns' device, and the
``(B,)`` values come back in one device-to-host copy per chunk.

Semantics, relative to :class:`InProcessExecutor`:

- **Failure isolation is per trial.** A NaN/inf row marks *that* trial
  ``broken``; its batch siblings still complete. A failure to stack or
  evaluate (heterogeneous pool, objective raising) breaks the affected
  chunk only, never the worker, and is never retried on another device.
- **Fidelity cohorts.** The single fidelity dim must be constant per
  launch; a mixed-fidelity pool is split into per-rung sub-batches
  (ASHA hands workers exactly such cohorts).
- **Heartbeats still matter.** Each trial's heartbeat is checked before
  its chunk launches and again after results land, so a reservation the
  sweeper reclaimed mid-flight is reported ``interrupted`` — the batch
  never complete-stomps a reassigned trial.

The executor runs on ``device`` (default ``cuda``; without CUDA it raises,
as every entry point of the port does). ``torch`` is imported when one is
built, not with this module.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from metaopt_tpu_torch.executor.base import ExecutionResult, Executor, HeartbeatFn, JudgeFn
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space.space import Space

#: vectorized objective: ``{name: (B,) column}`` → ``(B,)`` values
BatchObjectiveFn = Callable[[Mapping[str, Any]], Any]


class BatchedExecutor(Executor):
    """Evaluates pools of trials through one call of a vectorized objective.

    ``batch_fn`` takes the :meth:`Space.stack_points` column layout (as
    tensors on ``device``) and returns a ``(B,)`` value vector; ``space``
    proves the pool is batchable (and does the stacking) before anything
    runs. ``chunk_size`` bounds one launch — heartbeats are re-checked
    between chunks so a long pool can still abort early. ``result_name``
    is the name written on each trial's objective result.
    """

    def __init__(
        self,
        batch_fn: BatchObjectiveFn,
        space: Space,
        *,
        chunk_size: Optional[int] = None,
        result_name: str = "objective",
        device=None,
    ):
        reason = space.why_not_vectorizable()
        if reason is not None:
            raise ValueError(f"space is not vectorizable: {reason}")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        from metaopt_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.batch_fn = batch_fn
        self.space = space
        self.chunk_size = chunk_size
        self.result_name = result_name
        # telemetry counters; executors are shared across worker threads
        # in batched hunts, so bookkeeping takes the lock
        self._tel_lock = threading.Lock()
        self._pools = 0
        self._rows = 0

    # -- telemetry ---------------------------------------------------------
    def telemetry(self) -> Dict[str, int]:
        """The reference's keys. ``kernel_launches`` and ``pools`` both count
        chunks evaluated (one call of ``batch_fn`` each), not CUDA kernels:
        one such call launches hundreds of them."""
        with self._tel_lock:
            return {
                "kernel_launches": self._pools,
                "rows_evaluated": self._rows,
                "pools": self._pools,
            }

    # -- Executor contract -------------------------------------------------
    def execute(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        return self.execute_batch([trial], heartbeats=[heartbeat], judge=judge)[0]

    def execute_batch(
        self,
        trials: Sequence[Trial],
        heartbeats: Optional[Sequence[Optional[HeartbeatFn]]] = None,
        judge: Optional[JudgeFn] = None,
    ) -> List[ExecutionResult]:
        """Evaluate a pool; returns one :class:`ExecutionResult` per trial.

        ``judge`` is accepted for interface parity but unused: a batched
        pool completes as a unit, there is no partial-results stream to
        prune against.
        """
        n = len(trials)
        if heartbeats is None:
            heartbeats = [None] * n
        if len(heartbeats) != n:
            raise ValueError(f"{n} trials but {len(heartbeats)} heartbeats")
        out: List[Optional[ExecutionResult]] = [None] * n

        fid = self.space.fidelity
        # per-rung cohorts: one launch may only hold one budget level
        groups: Dict[Any, List[int]] = {}
        for i, t in enumerate(trials):
            key = t.params.get(fid.name) if fid is not None else None
            groups.setdefault(key, []).append(i)

        for idxs in groups.values():
            step = self.chunk_size or len(idxs)
            for start in range(0, len(idxs), step):
                chunk = idxs[start:start + step]
                for i, res in zip(chunk, self._run_chunk(trials, heartbeats, chunk)):
                    out[i] = res
        return out  # type: ignore[return-value]  # every index was assigned

    # -- internals ---------------------------------------------------------
    # mtpu: hotpath
    def _pool_eval(self, cols: Mapping[str, np.ndarray]):
        """One launch per pool: the columns to the device and the objective
        on all rows at once; the ``(B,)`` f32 values stay on the device."""
        import torch

        dev_cols = {name: torch.from_numpy(col).to(self.device) for name, col in cols.items()}
        return torch.as_tensor(self.batch_fn(dev_cols)).reshape(-1).to(torch.float32)

    def _pool_values(self, cols: Mapping[str, np.ndarray]) -> np.ndarray:
        """:meth:`_pool_eval` and the ``(B,)`` values back in one copy."""
        return self._pool_eval(cols).cpu().numpy().astype(np.float64)

    def _run_chunk(
        self,
        trials: Sequence[Trial],
        heartbeats: Sequence[Optional[HeartbeatFn]],
        chunk: List[int],
    ) -> List[ExecutionResult]:
        """One launch: stack → pool eval → fan results back out."""
        results: Dict[int, ExecutionResult] = {}
        live: List[int] = []
        for i in chunk:
            hb = heartbeats[i]
            if hb is not None and not hb():
                results[i] = ExecutionResult("interrupted", note="lost reservation")
            else:
                live.append(i)
        if live:
            try:
                cols, _ = self.space.stack_points([trials[i].params for i in live])
                values = self._pool_values(cols)
                if values.shape != (len(live),):
                    raise ValueError(f"objective returned {values.shape[0]} values "
                                     f"for {len(live)} rows")
            except KeyboardInterrupt:
                raise
            except Exception as e:  # a broken chunk must not kill the worker
                note = f"{type(e).__name__}: {e}"
                for i in live:
                    results[i] = ExecutionResult("broken", note=note)
                live = []
            else:
                with self._tel_lock:
                    self._pools += 1
                    self._rows += len(live)
        for row, i in enumerate(live):
            hb = heartbeats[i]
            if hb is not None and not hb():
                # reservation reclaimed while the pool ran: the result is
                # stale, some other worker owns this trial now
                results[i] = ExecutionResult(
                    "interrupted", note="lost reservation during evaluation"
                )
                continue
            v = float(values[row])
            if not np.isfinite(v):
                results[i] = ExecutionResult(
                    "broken", note=f"non-finite objective: {v}"
                )
            else:
                results[i] = ExecutionResult(
                    "completed",
                    results=[{
                        "name": self.result_name,
                        "type": "objective",
                        "value": v,
                    }],
                    exit_code=0,
                )
        return [results[i] for i in chunk]
