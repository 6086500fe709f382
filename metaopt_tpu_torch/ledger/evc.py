"""EVC — experiment version control: branching with trial adaptation.

Port of ``metaopt_tpu/ledger/evc.py``. Branching re-based onto the ledger:

- ``hunt --branch-from PARENT`` creates a NEW experiment whose document
  records its parent and bumps ``version`` (= parent.version + 1);
- the child's first produce() replays the parent's completed trials through
  a :class:`TrialAdapter` so its algorithm starts informed;
- adaptation rules:
  * dimension unchanged        → pass the value through,
  * prior/range changed        → keep the trial iff the value still fits,
  * dimension added in child   → fill from an explicit default
    (``--branch-default name=value``) — refusing to guess is the point,
  * dimension renamed in child → carry the parent value under the new
    name (``--branch-rename old=new``), filtered against the new prior,
  * dimension deleted in child → strip the value.

Adapted trials keep their results and point at the original via
``Trial.parent``, so provenance survives the branch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import Space


class BranchConflictError(ValueError):
    """The child space cannot absorb the parent's trials as configured."""


def branch_parent(doc: Dict[str, Any]) -> Optional[str]:
    """The experiment a document was branched from, if any.

    Two storage shapes exist: ``metadata.branch.parent`` (hunt
    ``--branch-from`` / ``--on-conflict branch``) and top-level
    ``parent`` (``db load --resolve bump``). Every surface that reasons
    about lineage (the CLI family walk, ``list`` trees, the web API)
    must read them through this one helper.
    """
    return ((doc.get("metadata") or {}).get("branch") or {}) \
        .get("parent") or doc.get("parent")


class TrialAdapter:
    """Maps one experiment's trials into a (possibly different) space."""

    def __init__(
        self,
        parent_space: Space,
        child_space: Space,
        defaults: Optional[Dict[str, Any]] = None,
        renames: Optional[Dict[str, str]] = None,
    ) -> None:
        self.parent_space = parent_space
        self.child_space = child_space
        defaults = dict(defaults or {})
        renames = dict(renames or {})  # old parent name -> new child name
        targets: Dict[str, str] = {}
        for old, new in renames.items():
            if old not in parent_space:
                raise BranchConflictError(
                    f"--branch-rename {old}={new}: parent has no "
                    f"dimension {old!r}"
                )
            if new not in child_space:
                raise BranchConflictError(
                    f"--branch-rename {old}={new}: child space has no "
                    f"dimension {new!r}"
                )
            if new in targets:
                raise BranchConflictError(
                    f"--branch-rename targets collide: both "
                    f"{targets[new]!r} and {old!r} map to {new!r}"
                )
            if new in parent_space:
                # refusing to guess is the point: `new` exists in BOTH
                # spaces, so pass-through and rename are ambiguous
                raise BranchConflictError(
                    f"--branch-rename {old}={new}: {new!r} already exists "
                    f"in the parent space — renaming onto it would "
                    f"silently discard one dimension's values"
                )
            targets[new] = old
        by_new = targets
        #: (name, action, dimension, fill_value_or_source)
        self._plan: List[tuple] = []
        for name, dim in child_space.items():
            if name in by_new:
                # renamed: carry the parent's value under the new name,
                # filtered against the (possibly different) new prior
                self._plan.append((name, "rename", dim, by_new[name]))
            elif name in parent_space:
                action = (
                    "pass"
                    if parent_space[name].configuration == dim.configuration
                    else "filter"
                )
                self._plan.append((name, action, dim, None))
            elif name in defaults:
                fill = defaults.pop(name)
                if fill not in dim:
                    raise BranchConflictError(
                        f"--branch-default {name}={fill!r} is outside {dim!r}"
                    )
                self._plan.append((name, "fill", dim, fill))
            else:
                raise BranchConflictError(
                    f"dimension {name!r} was added without a default; the "
                    f"parent's trials have no value for it — pass "
                    f"--branch-default {name}=<value>"
                )
        if defaults:
            raise BranchConflictError(
                f"--branch-default for unknown dimension(s): "
                f"{sorted(defaults)}"
            )
        renamed_away = set(renames)
        self.deleted = [
            n for n in parent_space.keys()
            if n not in child_space and n not in renamed_away
        ]
        self.renames = renames

    def adapt_params(self, params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Child-space params for a parent point, or None if it can't fit."""
        out: Dict[str, Any] = {}
        for name, action, dim, fill in self._plan:
            if action == "fill":
                out[name] = fill
                continue
            source = fill if action == "rename" else name
            if source not in params:
                return None
            value = params[source]
            if action in ("filter", "rename") and value not in dim:
                return None  # prior shrank / moved; the old point fell out
            out[name] = value
        return out

    def adapt(self, trial: Trial) -> Optional[Trial]:
        """A child-space completed trial carrying the parent's results."""
        params = self.adapt_params(trial.params)
        if params is None:
            return None
        adapted = Trial(
            params=params,
            experiment=trial.experiment,
            status=trial.status,
            results=[r.to_dict() for r in trial.results],
            parent=trial.id,
        )
        adapted.id = self.child_space.hash_point(params, with_fidelity=True)
        adapted.lineage = self.child_space.hash_point(params)
        return adapted

    def describe(self) -> Dict[str, Any]:
        """Serializable summary (stored in the child experiment document)."""
        return {
            "passed": [n for n, a, _, _ in self._plan if a == "pass"],
            "filtered": [n for n, a, _, _ in self._plan if a == "filter"],
            "filled": {n: f for n, a, _, f in self._plan if a == "fill"},
            "renamed": dict(self.renames),
            "deleted": list(self.deleted),
        }
