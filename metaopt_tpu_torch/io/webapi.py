"""Ledger summaries for the CLI (port of ``metaopt_tpu/io/webapi.py``).

Trimmed to the two read-only derivations ``list`` and ``status --workers``
print: :func:`_experiment_summary` and :func:`worker_table`. The
reference serves the same derivations over HTTP; that server is not
ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from metaopt_tpu_torch.ledger.backends import LedgerBackend
from metaopt_tpu_torch.ledger.evc import branch_parent


def _experiment_summary(ledger: LedgerBackend, name: str) -> Dict[str, Any]:
    """One-line experiment status; the backing store for ``list``.

    missing/None ``max_trials`` = unbounded (never done by count alone).
    """
    doc = ledger.load_experiment(name) or {}
    completed = ledger.count(name, "completed")
    max_trials = doc.get("max_trials")
    return {
        "name": name,
        "version": doc.get("version", 1),
        "parent": branch_parent(doc),
        "algorithm": next(iter(doc.get("algorithm", {})), None),
        "trials": ledger.count(name),
        "completed": completed,
        "max_trials": max_trials,
        "done": bool(doc.get("algo_done"))
        or (max_trials is not None and completed >= max_trials),
    }


def worker_table(ledger: LedgerBackend, name: str) -> List[Dict[str, Any]]:
    """Per-worker liveness derived from trial ownership + heartbeats.

    Every trial records its owning worker, reserved trials carry the
    heartbeat the executor pumps, finished trials keep their end time — so
    no extra registry is needed. Backs ``status --workers``.
    """
    now = time.time()
    workers: Dict[str, Dict[str, Any]] = {}
    for t in ledger.fetch(name):
        w = t.worker
        if not w:
            continue
        rec = workers.setdefault(w, {
            "worker": w, "reserved": 0, "completed": 0, "broken": 0,
            "interrupted": 0, "suspended": 0, "current": [],
            "last_seen": None,
        })
        if t.status in rec:
            rec[t.status] += 1
        if t.status == "reserved":
            rec["current"].append(t.id)
            seen = t.heartbeat or t.start_time
        else:
            seen = t.end_time or t.heartbeat
        if seen and (rec["last_seen"] is None or seen > rec["last_seen"]):
            rec["last_seen"] = seen
    out = sorted(workers.values(),
                 key=lambda r: -(r["last_seen"] or 0.0))
    for r in out:
        r["last_seen_age_s"] = (
            round(now - r["last_seen"], 1)
            if r["last_seen"] is not None else None
        )
    return out
