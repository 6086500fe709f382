"""Discrete-event scale simulator (port of ``metaopt_tpu/sim``).

Drives the REAL coordinator — `CoordServer` dispatch, WAL/snapshot/
reply-cache durability, hosted ASHA/hyperband/BOHB promotion, the fair
produce scheduler, heartbeats and the stale sweep — with tens of
thousands of simulated workers on a virtual clock, so pod-scale
robustness claims become repeatable sub-minute CI checks.

Entry points: ``python -m metaopt_tpu_torch simulate`` (CLI) and
:class:`Simulation` (library). The coordinator hosts its algorithms on
``Simulation(cfg, device=...)``, ``cuda`` unless the caller says
otherwise, so a simulated TPE runs on the card.
"""

from metaopt_tpu_torch.sim.clock import VirtualClock
from metaopt_tpu_torch.sim.engine import SimConfig, SimReport, Simulation

__all__ = ["VirtualClock", "SimConfig", "SimReport", "Simulation"]
