"""GPU executor: subprocess trials pinned to GPUs.

Port of ``metaopt_tpu/executor/tpu.py`` (``TPUExecutor``): each trial is
gang-scheduled onto an aligned power-of-two block of GPUs by the flock'd
registry of :mod:`~metaopt_tpu_torch.executor.topology`, the subprocess
sees only its GPUs (``CUDA_VISIBLE_DEVICES``), and the block is returned
on ANY exit path — completion, breakage, prune, timeout, SIGINT or an
exception — so a broken trial never leaks capacity.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Optional

from metaopt_tpu_torch.executor.base import ExecutionResult, HeartbeatFn, JudgeFn
from metaopt_tpu_torch.executor.subproc import SubprocessExecutor
from metaopt_tpu_torch.executor.topology import (
    ChipRegistry,
    SubSlice,
    chip_env,
    detect_slice_size,
)
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space.builder import CommandTemplate

log = logging.getLogger(__name__)


class GPUExecutor(SubprocessExecutor):
    def __init__(
        self,
        template: CommandTemplate,
        n_chips: int = 1,
        total_chips: Optional[int] = None,
        registry: Optional[ChipRegistry] = None,
        registry_path: Optional[str] = None,
        allocate_timeout_s: float = 600.0,
        allocate_poll_s: float = 0.5,
        **kwargs,
    ):
        # the device circuit breaker (park at a wedged card) lives in
        # SubprocessExecutor; its knobs (park_max_s, probe_fn, ...) pass
        # through **kwargs
        super().__init__(template, **kwargs)
        self.n_chips = int(n_chips)
        if registry is None:
            total = total_chips or detect_slice_size()
            # round the GPU count down to a power of two: blocks are aligned
            p = 1
            while p * 2 <= total:
                p *= 2
            if registry_path is None:
                # default to the flock'd per-host state file: every executor
                # on this host — other hunt PROCESSES and `--n-workers`
                # threads alike — must arbitrate the same physical GPUs, not
                # each believe all of them are free
                registry_path = os.path.join(
                    tempfile.gettempdir(), f"metaopt_tpu_torch-gpus-{p}.json")
            registry = ChipRegistry(p, state_path=registry_path)
        self.registry = registry
        self.allocate_timeout_s = allocate_timeout_s
        self.allocate_poll_s = allocate_poll_s

    def execute(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        block = self._acquire(trial, heartbeat)
        if block is None:
            return ExecutionResult(
                "interrupted",
                note=f"no {self.n_chips}-GPU block became available "
                f"within {self.allocate_timeout_s}s",
            )
        try:
            # MERGE the assignment — never replace the dict: the worker
            # loop persists its per-trial requeue budget in this same dict
            # (worker/loop.py), and clobbering it makes the budget infinite
            trial.resources.update(
                {
                    "chips": block.chips,
                    "slice": {"start": block.start, "size": block.size},
                    "env": chip_env(block),
                }
            )
            log.debug("trial %s pinned to GPUs %s", trial.id[:8], block.chips)

            def beating() -> bool:
                self.registry.heartbeat(block)
                return heartbeat() if heartbeat else True

            # the inherited breaker parks/arms inside (while holding the
            # block — nothing else can use it during a wedge anyway, and
            # `beating` keeps both the reservation and the registry lease
            # alive)
            return super().execute(trial, heartbeat=beating, judge=judge)
        finally:
            self.registry.free(block)  # every exit path returns the block

    def _acquire(
        self, trial: Trial, heartbeat: Optional[HeartbeatFn]
    ) -> Optional[SubSlice]:
        deadline = time.time() + self.allocate_timeout_s
        while time.time() < deadline:
            block = self.registry.allocate(self.n_chips, owner=trial.id)
            if block is not None:
                return block
            if heartbeat and not heartbeat():
                return None
            time.sleep(self.allocate_poll_s)
        return None
