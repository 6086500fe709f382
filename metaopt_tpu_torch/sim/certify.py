"""Promotion-correctness certifiers for the scale simulator (port of
``metaopt_tpu/sim/certify.py``).

Post-hoc structural invariants over the REAL algorithm instances the
coordinator hosted during a simulated run. Each checker returns a list
of human-readable violation strings (empty = certified). The invariants
are chosen to hold at ANY point of an asynchronous run — they do not
assume quiescence unless stated:

ASHA (asynchronous successive halving):
  A1. every promoted lineage has a recorded result in its rung;
  A2. a rung with ``n`` results promotes nothing until ``n >= eta``
      ("no trial promoted past an unfilled rung", the asynchronous
      analogue of the sync barrier) and never more than ``n - eta + 1``
      lineages in total. The naive ``n // eta`` cap is NOT an invariant
      of asynchronous halving: every promotion was in the top
      ``1/eta`` *at promotion time*, but later arrivals can displace
      it, and each arrival past ``eta`` can unlock at most one more
      promotion — hence the ``n - eta + 1`` bound (tight: realized by
      the strictly-worst-first completion order);
  A3. every result at rung ``i+1`` descends from a lineage rung ``i``
      actually promoted (no rung-skipping);
  A4. at quiescence only (``quiescent=True``): the rung's current top
      ``n // eta`` lineages are ALL promoted — completion-order
      invariance in the direction that matters: whatever the stragglers
      did to the interim ranking, no deserving lineage is left behind
      once promotion opportunities have drained.

Hyperband / BOHB (synchronous brackets):
  H1. no rung holds more lineages than its capacity;
  H2. results only for assigned lineages;
  H3. a rung with any assignment above it is full, and (at quiescence)
      complete — the synchronous promotion barrier.
"""

from __future__ import annotations

from typing import Any, List


def asha_violations(algo: Any, label: str = "asha",
                    quiescent: bool = False) -> List[str]:
    """Structural promotion invariants for an ``ASHA`` instance."""
    out: List[str] = []
    eta = int(getattr(algo, "eta", 2))
    for bi, bracket in enumerate(getattr(algo, "brackets", ())):
        rungs = bracket.rungs
        for ri, rung in enumerate(rungs):
            n = len(rung.results)
            promoted = len(rung.promoted)
            if promoted and n < eta:
                out.append(
                    f"{label}: bracket {bi} rung {ri} (budget "
                    f"{rung.budget}) promoted {promoted} lineage(s) "
                    f"from only {n} result(s) (< eta={eta}) — promotion "
                    "past an unfilled rung")
            elif promoted > max(0, n - eta + 1):
                out.append(
                    f"{label}: bracket {bi} rung {ri} (budget "
                    f"{rung.budget}) promoted {promoted} of {n} results "
                    f"(max {n - eta + 1} at eta={eta})")
            missing = rung.promoted - set(rung.results)
            if missing:
                out.append(
                    f"{label}: bracket {bi} rung {ri} promoted "
                    f"{len(missing)} lineage(s) with no recorded result")
            if ri > 0:
                strays = set(rung.results) - rungs[ri - 1].promoted
                if strays:
                    out.append(
                        f"{label}: bracket {bi} rung {ri} holds "
                        f"{len(strays)} result(s) never promoted from "
                        f"rung {ri - 1}")
            if quiescent and ri < len(rungs) - 1:
                ranked = sorted(rung.results.items(),
                                key=lambda kv: kv[1][0])
                left_behind = [lin for lin, _ in ranked[: n // eta]
                               if lin not in rung.promoted]
                if left_behind:
                    out.append(
                        f"{label}: bracket {bi} rung {ri} left "
                        f"{len(left_behind)} top-{n // eta} lineage(s) "
                        "unpromoted at quiescence")
    return out


def hyperband_violations(algo: Any, label: str = "hyperband",
                         quiescent: bool = False) -> List[str]:
    """Structural promotion invariants for ``Hyperband`` (and BOHB)."""
    out: List[str] = []
    for bi, bracket in enumerate(getattr(algo, "brackets", ())):
        rungs = bracket.rungs
        for ri, rung in enumerate(rungs):
            if len(rung.assigned) > rung.capacity:
                out.append(
                    f"{label}: bracket {bi} rung {ri} assigned "
                    f"{len(rung.assigned)} > capacity {rung.capacity}")
            strays = set(rung.results) - rung.assigned
            if strays:
                out.append(
                    f"{label}: bracket {bi} rung {ri} has "
                    f"{len(strays)} result(s) for unassigned lineages")
            if ri > 0 and rungs[ri].assigned:
                below = rungs[ri - 1]
                if not below.is_full:
                    out.append(
                        f"{label}: bracket {bi} rung {ri} populated "
                        f"while rung {ri - 1} is unfilled "
                        f"({len(below.assigned)}/{below.capacity}) — "
                        "promotion crossed the sync barrier")
                elif quiescent and not below.is_complete:
                    out.append(
                        f"{label}: bracket {bi} rung {ri} populated but "
                        f"rung {ri - 1} is incomplete at quiescence")
    return out


def promotion_violations(algo: Any, label: str = "",
                         quiescent: bool = False) -> List[str]:
    """Dispatch on algorithm shape: ASHA-style rungs carry ``promoted``,
    synchronous rungs carry ``assigned``. Algorithms with no brackets
    (random, TPE, …) trivially certify.

    ``quiescent`` here means "the experiment stopped" (e.g. its
    ``max_trials`` budget ran out) — enough for Hyperband's sync-barrier
    completeness check, but NOT for ASHA's A4 top-k closure, which
    additionally needs every promotion opportunity drained (a budget cut
    legitimately strands promotable candidates). Callers that drain
    promotions to a fixed point (the invariance property tests) call
    ``asha_violations(..., quiescent=True)`` directly."""
    brackets = getattr(algo, "brackets", None)
    if not brackets:
        return []
    rung0 = brackets[0].rungs[0]
    name = label or type(algo).__name__.lower()
    if hasattr(rung0, "promoted"):
        return asha_violations(algo, label=name)
    if hasattr(rung0, "assigned"):
        return hyperband_violations(algo, label=name, quiescent=quiescent)
    return []
