"""The in-script client: the single touchpoint inside a user's training code.

Port of ``metaopt_tpu/client/__init__.py``. ``report_results(list_of_dicts)``
writes JSON to a results path injected by the trial executor: this file
handshake IS the worker↔trial protocol (no socket, no RPC). The environment
names are the reference's (``METAOPT_TPU_RESULTS_PATH`` and friends), so a
script written for either package runs under the other's executor.

Also: ``report_partial(objective, step)`` streams intermediate objectives
(JSON lines in a sidecar file) for the executor's ``judge`` poll,
``stop_requested()`` reads the cooperative stop sentinel, and
``get_trial_info()`` exposes the trial's id/params to the script.

Every trial subprocess imports this module, so it stays cheap: it loads
neither ``torch`` nor the ledger/algorithm chain. The library API
(``build_experiment`` …) resolves lazily from :mod:`.api`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional

RESULTS_PATH_ENV = "METAOPT_TPU_RESULTS_PATH"
TRIAL_INFO_ENV = "METAOPT_TPU_TRIAL_INFO"
STOP_PATH_ENV = "METAOPT_TPU_STOP_PATH"

IS_ORCHESTRATED = RESULTS_PATH_ENV in os.environ


class ReportError(RuntimeError):
    pass


def _results_path() -> str:
    path = os.environ.get(RESULTS_PATH_ENV)
    if not path:
        raise ReportError(
            f"{RESULTS_PATH_ENV} is not set — this process was not launched by "
            "a metaopt-tpu executor. Guard the call with "
            "`if metaopt_tpu_torch.client.IS_ORCHESTRATED:` for standalone runs."
        )
    return path


def report_results(data: List[Mapping[str, Any]]) -> None:
    """Report final trial results. Each item:

    ``{"name": ..., "type": "objective" | "constraint" | "gradient" | "statistic",
       "value": ...}``

    At least one ``objective`` entry is required. The FIRST one is the
    scalar single-objective algorithms minimize; additional objective
    entries, in report order, form the objective vector consumed by
    multi-objective algorithms.
    """
    data = [dict(d) for d in data]
    n_obj = sum(1 for d in data if d.get("type") == "objective")
    if n_obj < 1:
        raise ReportError(
            f"report_results needs at least one objective entry, got {n_obj}"
        )
    for d in data:
        if not {"name", "type", "value"} <= set(d):
            raise ReportError(f"malformed result entry {d!r}")
    path = _results_path()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    # atomic, deliberately not durable: same-host IPC with the executor
    # that spawned us — if the HOST crashes the trial is re-run anyway,
    # so atomicity (never a torn read) is the whole contract here
    os.replace(tmp, path)  # mtpu: lint-ok MTP001 same-host IPC, atomicity-only


def report_objective(value: float, name: str = "objective") -> None:
    """Shorthand for the common single-scalar case."""
    report_results([{"name": name, "type": "objective", "value": float(value)}])


def stop_requested() -> bool:
    """Has the executor asked this trial to stop (judge pruned it)?

    The cooperative half of early stopping: the executor touches a stop
    sentinel, waits a grace period, then SIGTERMs. A script that polls
    this can report its partial results and exit cleanly instead of dying
    mid-step. Always False outside an orchestrated trial.
    """
    path = os.environ.get(STOP_PATH_ENV)
    return bool(path) and os.path.exists(path)


def report_partial(objective: float, step: int) -> None:
    """Stream an intermediate objective (for early stopping / rung judging).

    Appends a JSON line to ``<results path>.partial``; the executor polls it
    and feeds ``algo.judge()``.
    """
    path = _results_path() + ".partial"
    with open(path, "a") as f:
        f.write(json.dumps({"objective": float(objective), "step": int(step)}) + "\n")
        f.flush()


def get_trial_info() -> Optional[Dict[str, Any]]:
    """Trial id / params / fidelity / assigned devices, or None standalone."""
    raw = os.environ.get(TRIAL_INFO_ENV)
    return json.loads(raw) if raw else None


CKPT_ROOT_ENV = "METAOPT_TPU_CKPT_ROOT"


def checkpoint_paths(root: Optional[str] = None):
    """(own_dir, parent_dir_or_None) for PBT-style weight handoff.

    PBT continuations carry the donor trial's id in ``Trial.parent``; a
    script that saves its weights under ``own_dir`` and restores from
    ``parent_dir`` when present inherits the exploited member's training
    state. ``root`` defaults to ``$METAOPT_TPU_CKPT_ROOT`` (injected via
    ``hunt --ckpt-root``), else a per-experiment directory under the
    system temp dir. ``parent_dir`` is None when there is no parent or its
    checkpoint never materialized (broken donor) — scripts must treat that
    as cold start.

    Usage::

        own, parent = client.checkpoint_paths()
        if parent: restore(parent)
        ... train, save(own) ...
    """
    import tempfile

    info = get_trial_info() or {}
    root = root or os.environ.get(CKPT_ROOT_ENV) or os.path.join(
        tempfile.gettempdir(), "metaopt_tpu_ckpt",
        str(info.get("experiment") or "standalone"),
    )
    own = os.path.join(root, str(info.get("id", os.getpid())))
    os.makedirs(own, exist_ok=True)
    parent = info.get("parent")
    parent_dir = os.path.join(root, str(parent)) if parent else None
    if parent_dir is not None:
        # an existing-but-EMPTY dir means the donor called us too and then
        # died before saving anything — that's a cold start, not a restore
        try:
            if not os.listdir(parent_dir):
                parent_dir = None
        except OSError:
            parent_dir = None
    return own, parent_dir


PROFILE_DIR_ENV = "METAOPT_TPU_PROFILE_DIR"


class profiled:
    """Context manager: capture a ``torch.profiler`` trace of this trial.

    No-op unless the executor injected ``METAOPT_TPU_PROFILE_DIR`` (set
    ``profile_dir=`` on the executor / ``--profile-dir`` on the CLI). The
    trace (CPU and, where a card is visible, CUDA activity) lands as a
    Chrome trace in ``<profile_dir>/<trial_id>/trace.json``.

    Usage inside a user script::

        with client.profiled():
            for step in range(n):
                train_step(...)
    """

    def __init__(self) -> None:
        base = os.environ.get(PROFILE_DIR_ENV)
        self._dir: Optional[str] = None
        self._prof = None
        if base:
            info = get_trial_info() or {}
            self._dir = os.path.join(base, str(info.get("id", os.getpid())))

    def __enter__(self) -> "profiled":
        if self._dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self._dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))
            self._prof = None


#: the library-first flow (build_experiment(...).workon(fn) / suggest() /
#: observe()). Lazy (PEP 562): every trial subprocess imports this package
#: for report_results, and must not pay the ledger/algo/torch import chain.
_LAZY_API = ("build_experiment", "ExperimentClient", "WaitingForTrials",
             "CompletedExperiment")


def __getattr__(name):
    if name in _LAZY_API:
        from metaopt_tpu_torch.client import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "report_results",
    "report_objective",
    "report_partial",
    "stop_requested",
    "STOP_PATH_ENV",
    "get_trial_info",
    "checkpoint_paths",
    "profiled",
    "IS_ORCHESTRATED",
    "RESULTS_PATH_ENV",
    "TRIAL_INFO_ENV",
    "PROFILE_DIR_ENV",
    "CKPT_ROOT_ENV",
    "ReportError",
    *_LAZY_API,
]
