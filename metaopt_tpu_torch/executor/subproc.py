"""Subprocess executor: the black-box trial protocol.

Port of ``metaopt_tpu/executor/subproc.py``: materialize params into the
user's argv (and config file template if present), launch the script as a
subprocess, wait, read the results JSON written via
``client.report_results``. Non-zero exit → broken; SIGINT → interrupted.
Also kept from the reference:

- heartbeat callbacks while waiting,
- the ``judge`` poll: streams ``client.report_partial`` lines to the
  algorithm's early-stop hook and stops pruned trials, first through the
  stop sentinel, then by SIGTERM after ``prune_grace_s``,
- env injection (``METAOPT_TPU_RESULTS_PATH``, ``METAOPT_TPU_TRIAL_INFO``,
  ``METAOPT_TPU_STOP_PATH``, the profile and checkpoint roots, and the
  caller's ``extra_env``),
- the device circuit breaker, keyed on CUDA: after a trial breaks by
  timeout where a card is meant to be visible, the card is probed in a
  disposable child before the next launch, and the executor parks while
  it does not answer.

The reference's ``jax_cache_dir`` has no counterpart: the port JITs
nothing on this path, and its CUDA kernels are built once per source hash
into a build directory that every trial process shares.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import signal
import subprocess
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.client import (
    CKPT_ROOT_ENV,
    PROFILE_DIR_ENV,
    RESULTS_PATH_ENV,
    STOP_PATH_ENV,
    TRIAL_INFO_ENV,
)
from metaopt_tpu_torch.executor.base import ExecutionResult, Executor, HeartbeatFn, JudgeFn
from metaopt_tpu_torch.executor.faults import faults
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space.builder import CommandTemplate
from metaopt_tpu_torch.utils.procs import cuda_backend_reachable

log = logging.getLogger(__name__)


def _stop_path(results_path: str) -> str:
    """The stop-sentinel path — ONE derivation for the env injection and
    the prune-time touch, so the two can never drift apart."""
    return results_path + ".stop"


class SubprocessExecutor(Executor):
    def __init__(
        self,
        template: CommandTemplate,
        working_dir: Optional[str] = None,
        interpreter: Optional[List[str]] = None,
        poll_interval_s: float = 0.2,
        heartbeat_every_s: float = 5.0,
        timeout_s: Optional[float] = None,
        prune_grace_s: float = 1.0,
        extra_env: Optional[Dict[str, str]] = None,
        profile_dir: Optional[str] = None,
        ckpt_root: Optional[str] = None,
        device_probe_timeout_s: float = 90.0,
        park_max_s: float = 1800.0,
        park_poll_s: float = 60.0,
        probe_fn=None,
    ):
        self.template = template
        self.working_dir = working_dir
        self.interpreter = interpreter  # e.g. [sys.executable]; None = direct exec
        self.poll_interval_s = poll_interval_s
        self.heartbeat_every_s = heartbeat_every_s
        self.timeout_s = timeout_s
        self.prune_grace_s = prune_grace_s
        self.extra_env: Dict[str, str] = dict(extra_env or {})
        if profile_dir:  # opt-in per-trial torch.profiler traces (client.profiled)
            self.extra_env[PROFILE_DIR_ENV] = profile_dir
        if ckpt_root:  # PBT weight handoff root (client.checkpoint_paths)
            self.extra_env[CKPT_ROOT_ENV] = ckpt_root
        # device circuit breaker: a wedged CUDA runtime or card makes EVERY trial
        # burn its full wall-clock timeout and break — three of those and
        # the worker's max_broken guard aborts the hunt over an
        # infrastructure fault. After a timeout-shaped breakage (where a
        # card is meant to be visible only), probe the card in a disposable
        # child before the next launch; while it does not answer, PARK
        # (pumping the reservation heartbeat) instead of feeding trials to
        # a dead card.
        self.device_probe_timeout_s = device_probe_timeout_s
        self.park_max_s = park_max_s
        self.park_poll_s = park_poll_s
        self._probe = probe_fn or cuda_backend_reachable
        self._suspect_device = False

    # -- device circuit breaker --------------------------------------------
    @staticmethod
    def _device_expected() -> bool:
        """Is there a CUDA card this environment is SUPPOSED to reach?

        Distinguishes "no card ever" (breaker stays disarmed — on a CPU
        box the probe returns False by design and would park every trial
        after one slow script) from "the card stopped answering" (park):
        ``CUDA_VISIBLE_DEVICES`` is not set empty and a ``/dev/nvidia*``
        device node exists.
        """
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None and not visible.strip():
            return False
        return bool(glob.glob("/dev/nvidia[0-9]*"))

    def _probe_with_beats(self, heartbeat: Optional[HeartbeatFn]):
        """Run the (blocking, up to 90s) probe while pumping heartbeats.

        The probe child can outlive the stale-reservation window — going
        silent for its whole duration would let another worker steal the
        trial mid-probe. Returns True/False (probe verdict) or None when
        the reservation was lost while waiting.
        """
        out: Dict[str, bool] = {}

        def run() -> None:
            out["ok"] = bool(
                self._probe(timeout_s=self.device_probe_timeout_s)
            )

        th = threading.Thread(target=run, daemon=True)
        th.start()
        while th.is_alive():
            if heartbeat and not heartbeat():
                return None  # probe child dies on its own deadline
            th.join(timeout=2.0)
        return out.get("ok", False)

    def _await_device(self, heartbeat: Optional[HeartbeatFn]) -> str:
        """Probe until the card answers; park (beating) while it won't.

        ``"ok"`` = device reachable (suspicion cleared); ``"budget"`` =
        park budget exhausted; ``"lost"`` = reservation lost meanwhile.
        """
        deadline = time.time() + self.park_max_s
        while True:
            verdict = self._probe_with_beats(heartbeat)
            if verdict is None:
                return "lost"
            if verdict:
                self._suspect_device = False
                return "ok"
            if time.time() >= deadline:
                return "budget"
            log.warning(
                "CUDA card unreachable; parking %.1fs before re-probe "
                "(not launching trials at a dead device)", self.park_poll_s,
            )
            sleep_until = time.time() + self.park_poll_s
            while time.time() < min(sleep_until, deadline):
                if heartbeat and not heartbeat():
                    return "lost"
                time.sleep(min(5.0, self.park_poll_s))

    # -- env/argv assembly -------------------------------------------------
    def _prepare(self, trial: Trial, tmpdir: str) -> tuple[List[str], Dict[str, str], str]:
        results_path = os.path.join(tmpdir, "results.json")
        config_out = None
        if self.template.has_config:
            ext = os.path.splitext(self.template.config_path or "c.yaml")[1]
            config_out = os.path.join(tmpdir, f"trial_config{ext}")
            self.template.materialize_config(trial.params, config_out)
        argv = self.template.format(trial.params, config_out=config_out)
        if self.interpreter:
            argv = list(self.interpreter) + argv
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(trial.resources.get("env", {}))
        # the trial process must be able to import metaopt_tpu_torch.client
        # even when the framework runs from a source tree, not site-packages
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        parts = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join([pkg_root] + [p for p in parts if p])
        env[RESULTS_PATH_ENV] = results_path
        env[STOP_PATH_ENV] = _stop_path(results_path)
        env[TRIAL_INFO_ENV] = json.dumps(
            {
                "id": trial.id,
                "experiment": trial.experiment,
                "params": trial.params,
                "parent": trial.parent,
                "resources": {k: v for k, v in trial.resources.items() if k != "env"},
            }
        )
        return argv, env, results_path

    @staticmethod
    def _read_partial(path: str, already: int) -> List[Dict[str, Any]]:
        try:
            with open(path) as f:
                lines = f.readlines()
        except FileNotFoundError:
            return []
        out = []
        for line in lines[already:]:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # torn tail write; picked up next poll
        return out

    # -- main --------------------------------------------------------------
    def execute(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        if self._suspect_device:
            outcome = self._await_device(heartbeat)
            if outcome == "lost":
                return ExecutionResult(
                    "interrupted",
                    note="lost reservation while parked at an "
                         "unreachable CUDA card",
                )
            if outcome == "budget":
                return ExecutionResult(
                    "interrupted",
                    note=f"CUDA card unreachable; parked "
                    f"{self.park_max_s:.0f}s without recovery (trial "
                    f"released for retry)",
                    requeue=True,
                )
        result = self._execute_inner(trial, heartbeat, judge)
        # arm ONLY on the executor's own wall-clock-timeout note (a
        # script's stderr tail may mention "timeout" for other reasons)
        if (result.status == "broken"
                and (result.note or "").startswith("timeout after")
                and self._device_expected()):
            self._suspect_device = True
            log.warning(
                "trial %s broke by timeout — probing the CUDA card "
                "before the next launch", trial.id[:8],
            )
            # Attribution: if the card is down RIGHT NOW, the timeout was
            # infrastructure, not the user script — "broken" would count
            # it toward max_broken and a wedged card would abort the hunt.
            # Reclassify as interrupted: the reservation is released for
            # retry and the next execute() parks on the armed suspicion.
            verdict = self._probe_with_beats(heartbeat)
            if verdict is None:
                return ExecutionResult(
                    "interrupted",
                    note="lost reservation while attributing a timeout",
                )
            if verdict is False:
                return ExecutionResult(
                    "interrupted",
                    note=f"{result.note}, with the CUDA card unreachable "
                         "— attributed to a device wedge; trial released "
                         "for retry",
                    requeue=True,
                )
            self._suspect_device = False  # card fine: a real timeout
        return result

    def _execute_inner(
        self,
        trial: Trial,
        heartbeat: Optional[HeartbeatFn] = None,
        judge: Optional[JudgeFn] = None,
    ) -> ExecutionResult:
        with tempfile.TemporaryDirectory(prefix="mtpu_trial_") as tmpdir:
            argv, env, results_path = self._prepare(trial, tmpdir)
            # stdout/stderr go to files, not PIPEs: an undrained PIPE deadlocks
            # a chatty script once the ~64KB buffer fills
            stdout_path = os.path.join(tmpdir, "stdout")
            stderr_path = os.path.join(tmpdir, "stderr")
            if faults.fire("spawn_fail"):
                return ExecutionResult("broken", note="spawn failed: injected")
            try:
                with open(stdout_path, "wb") as so, open(stderr_path, "wb") as se:
                    proc = subprocess.Popen(
                        argv,
                        env=env,
                        cwd=self.working_dir,
                        stdout=so,
                        stderr=se,
                        start_new_session=True,  # isolate signals (we kill the group)
                    )
            except OSError as e:
                return ExecutionResult("broken", note=f"spawn failed: {e}")

            if faults.fire("kill_trial"):  # simulate mid-run preemption
                self._kill(proc)

            partial: List[Dict[str, Any]] = []
            started = time.time()
            last_beat = started
            pruned = False
            try:
                while True:
                    rc = proc.poll()
                    if rc is not None:
                        break
                    now = time.time()
                    if self.timeout_s and now - started > self.timeout_s:
                        self._kill(proc)
                        return ExecutionResult(
                            "broken", note=f"timeout after {self.timeout_s}s"
                        )
                    if heartbeat and now - last_beat >= self.heartbeat_every_s:
                        last_beat = now
                        if faults.fire("drop_heartbeat") or not heartbeat():
                            self._kill(proc)
                            return ExecutionResult(
                                "interrupted", note="lost reservation"
                            )
                    new = self._read_partial(results_path + ".partial", len(partial))
                    if new:
                        partial.extend(new)
                        if judge:
                            decision = judge(trial, partial)
                            if decision and decision.get("stop"):
                                pruned = True
                                last_beat = self._stop_pruned(
                                    proc, results_path, started, last_beat,
                                    heartbeat)
                                break
                    time.sleep(self.poll_interval_s)
            except KeyboardInterrupt:
                self._kill(proc)
                proc.wait()
                return ExecutionResult("interrupted", note="SIGINT")

            rc = proc.returncode if not pruned else 0
            results = self._collect(results_path, partial, pruned)
            if results is None:
                try:
                    with open(stderr_path, "rb") as f:
                        stderr_tail = f.read()[-2000:]
                except OSError:
                    stderr_tail = b""
                return ExecutionResult(
                    "broken",
                    exit_code=rc,
                    note=(
                        f"exit={rc}, no results reported; stderr tail: "
                        f"{stderr_tail.decode(errors='replace')}"
                    ),
                )
            if rc != 0:
                return ExecutionResult(
                    "broken", exit_code=rc, note=f"non-zero exit {rc}"
                )
            note = "pruned by judge" if pruned else ""
            return ExecutionResult("completed", results=results, exit_code=rc, note=note)

    def _stop_pruned(self, proc: subprocess.Popen, results_path: str,
                     started: float, last_beat: float,
                     heartbeat: Optional[HeartbeatFn]) -> float:
        """Stop a trial the judge pruned; returns the last beat's time.

        Cooperative first: touch the stop sentinel (client.stop_requested)
        so the script can report and exit cleanly; SIGTERM only after the
        grace. The lease must not lapse during a long grace, so keep
        beating (and honor the overall timeout) while waiting.
        """
        self._touch(_stop_path(results_path))
        deadline = time.time() + self.prune_grace_s
        while proc.poll() is None and time.time() < deadline:
            now = time.time()
            if self.timeout_s and now - started > self.timeout_s:
                break
            if heartbeat and now - last_beat >= self.heartbeat_every_s:
                last_beat = now
                if not heartbeat():
                    break
            time.sleep(self.poll_interval_s)
        if proc.poll() is None:
            self._kill(proc)
        proc.wait()
        return last_beat

    @staticmethod
    def _touch(path: str) -> None:
        try:
            with open(path, "w"):
                pass
        except OSError:
            pass  # sentinel is best-effort; the SIGTERM fallback remains

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass

    @staticmethod
    def _collect(
        results_path: str, partial: List[Dict[str, Any]], pruned: bool
    ) -> Optional[List[Dict[str, Any]]]:
        """Final results file wins; a pruned trial falls back to its last
        partial objective (the rung's measurement, per ASHA semantics)."""
        try:
            with open(results_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        if partial:
            last = partial[-1]
            return [
                {
                    "name": "objective",
                    "type": "objective",
                    "value": float(last["objective"]),
                },
                {
                    "name": "pruned_at_step" if pruned else "last_step",
                    "type": "statistic",
                    "value": int(last.get("step", -1)),
                },
            ]
        return None
