"""Trial: the value object for one evaluation.

ref: src/metaopt/core/worker/trial.py — params, typed results
(objective | constraint | gradient | statistic), the status lifecycle
``new → reserved → {completed, interrupted, broken, suspended}``, submit/start/
end times, worker id, dict⇄object round-trip for persistence. Additions, as
in the reference package: a ``lineage`` id that excludes the fidelity axis
(ASHA promotions share a lineage), a ``heartbeat`` timestamp (first-class
here), and a ``resources`` field for the devices a trial was pinned to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock
from metaopt_tpu_torch.utils.hashing import jsonable, point_hash

#: Clock used for submit/start/end/heartbeat stamps.
_CLOCK: Clock = SYSTEM_CLOCK

#: Legal status values and transitions.
STATUSES = ("new", "reserved", "completed", "interrupted", "broken", "suspended")
_TRANSITIONS = {
    "new": {"reserved"},
    "reserved": {"completed", "interrupted", "broken", "suspended", "new"},
    "suspended": {"reserved", "new"},
    "interrupted": {"new", "reserved"},
    "broken": {"new", "reserved"},  # allow manual retry
    "completed": set(),
}

RESULT_TYPES = ("objective", "constraint", "gradient", "statistic")


@dataclass
class Result:
    name: str
    type: str
    value: Any

    def __post_init__(self):
        if self.type not in RESULT_TYPES:
            raise ValueError(
                f"result type {self.type!r} not in {RESULT_TYPES}"
            )

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "type": self.type, "value": self.value}


class InvalidTrialTransition(RuntimeError):
    pass


def _copy_json_tree(value: Any) -> Any:
    """Deep-copy nested list/dict structure; scalars pass through.

    Trial fields are JSON-native after ``__post_init__`` (see ``jsonable``),
    so this is the full deep copy ``from_dict(to_dict())`` used to provide.
    """
    if isinstance(value, list):
        return [_copy_json_tree(v) for v in value]
    if isinstance(value, dict):
        return {k: _copy_json_tree(v) for k, v in value.items()}
    return value


@dataclass
class Trial:
    """One evaluation of a point in the search space."""

    params: Dict[str, Any]
    experiment: str = ""
    id: str = ""
    lineage: str = ""
    status: str = "new"
    results: List[Result] = field(default_factory=list)
    submit_time: Optional[float] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    heartbeat: Optional[float] = None
    worker: Optional[str] = None
    #: chips / sub-slice assigned by the executor, e.g. {"chips": [0,1,2,3]}
    resources: Dict[str, Any] = field(default_factory=dict)
    #: id of the trial this one was promoted from (ASHA/Hyperband lineage)
    parent: Optional[str] = None
    exit_code: Optional[int] = None

    def __post_init__(self):
        # shaped dims sample as numpy arrays: normalize to JSON-native
        # lists at the boundary so every ledger backend round-trips them
        self.params = {k: jsonable(v) for k, v in self.params.items()}
        if not self.id:
            self.id = point_hash(self.params)
        if self.submit_time is None:
            self.submit_time = _CLOCK.time()
        if self.status not in STATUSES:
            raise ValueError(f"unknown status {self.status!r}")
        self.results = [
            r if isinstance(r, Result) else Result(**r) for r in self.results
        ]

    # -- lifecycle --------------------------------------------------------
    def transition(self, new_status: str) -> None:
        if new_status not in STATUSES:
            raise ValueError(f"unknown status {new_status!r}")
        if new_status not in _TRANSITIONS[self.status]:
            raise InvalidTrialTransition(
                f"trial {self.id}: illegal {self.status} → {new_status}"
            )
        self.status = new_status
        now = _CLOCK.time()
        if new_status == "reserved":
            self.start_time = now
            self.heartbeat = now
        elif new_status in ("completed", "broken", "interrupted"):
            self.end_time = now

    def reset_to_new(self) -> None:
        """Return to ``new``, clearing the residue a past run left behind.

        A revived trial must not look like it already ran: worker claim,
        timing, heartbeat, exit code, AND results all reset so the
        reserve CAS, the status surfaces, and ``Trial.objective`` (which
        reads the FIRST objective-typed result — a stale one would shadow
        the re-run's) treat it exactly like a fresh registration.
        Used by ``resume`` and the worker loop's requeue path.
        """
        self.status = "new"
        self.worker = None
        self.start_time = None
        self.end_time = None
        self.heartbeat = None
        self.exit_code = None
        self.results = []
        # stale device assignments must not leak into the next run's env
        # (the executor re-injects resources["env"] at launch)
        self.resources = {}

    # -- results ----------------------------------------------------------
    @property
    def objective(self) -> Optional[float]:
        """The first objective-typed result's value (the scalar being minimized)."""
        for r in self.results:
            if r.type == "objective":
                return float(r.value)
        return None

    @property
    def objectives(self) -> List[float]:
        """All objective-typed result values, in report order.

        Single-objective algorithms read ``objective`` (the first);
        multi-objective ones (``motpe``) consume this full vector.
        """
        return [float(r.value) for r in self.results if r.type == "objective"]

    @property
    def constraints(self) -> List[Result]:
        return [r for r in self.results if r.type == "constraint"]

    @property
    def gradient(self) -> Optional[Result]:
        for r in self.results:
            if r.type == "gradient":
                return r
        return None

    @property
    def statistics(self) -> List[Result]:
        return [r for r in self.results if r.type == "statistic"]

    def attach_results(self, results: List[Mapping[str, Any]]) -> None:
        for r in results:
            self.results.append(r if isinstance(r, Result) else Result(**r))

    # -- persistence ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "lineage": self.lineage,
            "experiment": self.experiment,
            "params": dict(self.params),
            "status": self.status,
            "results": [r.to_dict() for r in self.results],
            "submit_time": self.submit_time,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "heartbeat": self.heartbeat,
            "worker": self.worker,
            "resources": dict(self.resources),
            "parent": self.parent,
            "exit_code": self.exit_code,
        }

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "Trial":
        return cls(**{k: v for k, v in doc.items()})

    def clone(self) -> "Trial":
        """Deep copy, equivalent to ``from_dict(to_dict())`` minus the dict
        round-trip. The in-memory ledger snapshots through this on every
        register/reserve/fetch, so it skips re-validation (__post_init__)
        of values that already passed it at construction.
        """
        t = object.__new__(Trial)
        d = t.__dict__
        d.update(self.__dict__)
        d["params"] = _copy_json_tree(self.params)
        d["results"] = [
            Result(r.name, r.type, _copy_json_tree(r.value))
            for r in self.results
        ]
        d["resources"] = _copy_json_tree(self.resources)
        return t

    def __repr__(self) -> str:
        obj = self.objective
        return (
            f"Trial(id={self.id[:8]}, status={self.status}, "
            f"params={self.params}, objective={obj})"
        )
