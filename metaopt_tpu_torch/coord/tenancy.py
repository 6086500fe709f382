"""Multi-tenant produce scheduling (port of ``metaopt_tpu/coord/tenancy.py``;
numpy-free host code, exact against the reference's for the same clock and
request sequence).

One coordinator serves fleets of experiments owned by many
tenants, and the produce leg of ``worker_cycle`` is the contended
resource: a hosted algorithm fit is milliseconds-to-seconds of CPU, so a
hot tenant hammering one experiment with 32 workers can starve a thousand
one-worker tenants of suggestion throughput long before the socket plane
saturates. :class:`FairProduceScheduler` arbitrates that capacity.

The discipline is a windowed weighted deficit round-robin:

- Each produce request costs one grant. Within a scheduling window a
  tenant may hold at most ``share × (total grants so far) + burst``
  grants, where ``share`` is its weight over the weights of all *active*
  tenants (active = requested within ``active_window_s``).
- A denied request is NOT queued — the worker cycle simply skips its
  produce leg this round (it still completes/reserves/counts), retrying
  on its next cycle. Capacity therefore shifts, it is never parked: with
  a single active tenant every request is granted (work conservation),
  and a tenant that stops requesting ages out of the active set after
  ``active_window_s`` and stops constraining anyone.
- Optional absolute per-tenant ``quotas`` (grants per window) cap a
  tenant below its fair share — the operator knob for batch tenants.

The scheduler itself is deliberately lock-free: :class:`CoordServer`
serializes calls under its ``_tenant_lock``, which keeps this class
trivially unit-testable with a fake clock.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

__all__ = ["FairProduceScheduler", "jain_index"]


def jain_index(xs: Iterable[float]) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over per-tenant shares.

    1.0 is perfectly fair; ``1/n`` is one tenant taking everything.
    """
    vals = [float(x) for x in xs]
    if not vals:
        return 1.0
    total = sum(vals)
    sq = sum(v * v for v in vals)
    if sq <= 0.0:
        return 1.0
    return (total * total) / (len(vals) * sq)


class FairProduceScheduler:
    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        quotas: Optional[Dict[str, int]] = None,
        window_s: float = 0.5,
        burst: int = 2,
        active_window_s: float = 2.0,
    ) -> None:
        self.weights = dict(weights or {})
        self.quotas = dict(quotas or {})
        self.window_s = float(window_s)
        self.burst = int(burst)
        self.active_window_s = float(active_window_s)
        self._window_start = 0.0
        #: grants inside the current window (reset on roll)
        self._granted: Dict[str, int] = {}
        #: tenant → last produce-request timestamp (active-set membership)
        self._last_req: Dict[str, float] = {}
        #: lifetime accounting, surfaced by the ``tenant_stats`` op
        self.total_granted: Dict[str, int] = {}
        self.total_denied: Dict[str, int] = {}

    def weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, 1.0))
        return w if w > 0.0 else 1.0

    def _active(self, now: float) -> list:
        horizon = now - self.active_window_s
        # prune while scanning so the map tracks live tenants, not history
        dead = [t for t, ts in self._last_req.items() if ts < horizon]
        for t in dead:
            self._last_req.pop(t, None)
        return list(self._last_req)

    def admit(self, tenant: str, now: Optional[float] = None) -> bool:
        """One produce-leg admission decision for ``tenant``; True = run
        the produce leg now, False = skip it this cycle (retryable)."""
        if now is None:
            now = time.monotonic()
        self._last_req[tenant] = now
        if now - self._window_start >= self.window_s:
            self._window_start = now
            self._granted.clear()
        held = self._granted.get(tenant, 0)
        quota = self.quotas.get(tenant)
        if quota is not None and held >= int(quota):
            self.total_denied[tenant] = self.total_denied.get(tenant, 0) + 1
            return False
        active = self._active(now)
        if len(active) > 1:
            wsum = sum(self.weight(t) for t in active)
            share = self.weight(tenant) / wsum
            total = sum(self._granted.values())
            if held >= share * (total + 1) + self.burst:
                self.total_denied[tenant] = (
                    self.total_denied.get(tenant, 0) + 1)
                return False
        self._granted[tenant] = held + 1
        self.total_granted[tenant] = self.total_granted.get(tenant, 0) + 1
        return True

    def grant_order(self, tenants: Iterable[str]) -> Dict[str, float]:
        """Tenant → priority for the fused suggest plane's demand sweep.

        The :class:`~metaopt_tpu_torch.coord.fuser.SuggestFuser` collects
        pending demand across ALL resident experiments each tick; it
        does not consume produce grants (fused refills are speculative
        background work, not reply-path capacity), but it ORDERS its
        sweep by each tenant's unmet share — weight divided by grants
        already held this window — so when a tick's bucket budget runs
        out, the tenants the produce plane has served least keep their
        prefetch pools warm first. Pure read: no window roll, no
        accounting mutation. Serialized under ``_tenant_lock`` like
        every other entry point.
        """
        out: Dict[str, float] = {}
        for t in tenants:
            held = self._granted.get(t, 0)
            out[t] = self.weight(t) / (1.0 + held)
        return out

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant lifetime accounting (``tenant_stats`` reply body)."""
        out: Dict[str, Dict[str, float]] = {}
        for t in set(self.total_granted) | set(self.total_denied):
            out[t] = {
                "granted": self.total_granted.get(t, 0),
                "denied": self.total_denied.get(t, 0),
                "weight": self.weight(t),
            }
        return out
