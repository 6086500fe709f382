"""Experiment version control (port of ``metaopt_tpu/ledger/evc.py``).

Trimmed to :func:`branch_parent`, which ``list`` and the CLI's version
family walk read. Branching itself (``TrialAdapter``, ``--branch-from``,
``--on-conflict branch``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def branch_parent(doc: Dict[str, Any]) -> Optional[str]:
    """The experiment a document was branched from, if any.

    Two storage shapes exist: ``metadata.branch.parent`` (hunt
    ``--branch-from`` / ``--on-conflict branch``) and top-level
    ``parent`` (``db load --resolve bump``). Every surface that reasons
    about lineage must read them through this one helper.
    """
    return ((doc.get("metadata") or {}).get("branch") or {}) \
        .get("parent") or doc.get("parent")
