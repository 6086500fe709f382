"""The port's scale simulator: clock seam, determinism, durability, and
the reference's digest.

The cases restate ``tests/unit/test_sim.py`` and the two 1k-worker cases
of ``tests/functional/test_sim_scale.py`` that are not marked slow,
against ``metaopt_tpu_torch.sim``. Cross-package, exactly: for the numpy
algorithms (ASHA, Hyperband) the port's event log hashes to the
reference's digest for the same seed and fault schedule — any difference
in event order, float formatting, the fault injector's seeded streams or
heap tie-breaks would show there — and the reports' keys are equal.

The coordinator hosts on the CPU (``device="cpu"``); without it the
simulation resolves ``cuda`` and raises on a machine without CUDA.
"""

import json
import threading

import pytest

from metaopt_tpu.sim import SimConfig as RefSimConfig
from metaopt_tpu.sim import Simulation as RefSimulation
from metaopt_tpu_torch.coord.server import CoordServer
from metaopt_tpu_torch.ledger.trial import Trial, set_trial_clock
from metaopt_tpu_torch.sim import SimConfig, Simulation, VirtualClock
from metaopt_tpu_torch.sim.engine import DEFAULT_FAULTS
from metaopt_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


def run(cfg):
    return Simulation(cfg, device="cpu").run()


class TestVirtualClock:
    def test_wall_and_monotonic_move_in_lockstep(self):
        c = VirtualClock()
        t0, m0 = c.time(), c.monotonic()
        c.advance(5.0)
        assert c.monotonic() == m0 + 5.0
        assert c.time() == t0 + 5.0

    def test_sleep_advances_instead_of_blocking(self):
        c = VirtualClock()
        c.sleep(3600.0)
        assert c.monotonic() == 3600.0
        c.sleep(0.0)
        c.sleep(-1.0)
        assert c.monotonic() == 3600.0

    def test_advance_to_never_goes_backwards(self):
        c = VirtualClock()
        c.advance_to(10.0)
        c.advance_to(4.0)
        assert c.monotonic() == 10.0
        with pytest.raises(ValueError):
            c.advance(-1.0)

    def test_system_clock_tracks_real_time(self):
        import time as _t

        assert isinstance(SYSTEM_CLOCK, Clock)
        assert abs(SYSTEM_CLOCK.time() - _t.time()) < 5.0


class TestClockSeam:
    def test_trial_stamps_follow_injected_clock(self):
        clk = VirtualClock(start=100.0)
        prev = set_trial_clock(clk)
        try:
            t = Trial(params={"x": 1}, experiment="e")
            assert t.submit_time == clk.time()
            clk.advance(7.0)
            t.transition("reserved")
            assert t.start_time == clk.time()
        finally:
            set_trial_clock(prev)
        t2 = Trial(params={"x": 2}, experiment="e")
        assert abs(t2.submit_time - SYSTEM_CLOCK.time()) < 5.0

    def test_stale_sweep_runs_on_virtual_time(self):
        clk = VirtualClock()
        prev = set_trial_clock(clk)
        srv = CoordServer(
            host_algorithms=True, stale_timeout_s=30.0,
            sweep_interval_s=5.0, produce_coalesce_ms=0.0, clock=clk,
            device="cpu",
        )
        try:
            srv._recover()
            assert srv.inner.clock is clk
            srv._handle({"op": "create_experiment", "req": "c", "args": {
                "config": {"name": "e1",
                           "space": {"x": "uniform(0, 1)"},
                           "algorithm": {"random": {"seed": 1}},
                           "max_trials": 4, "pool_size": 2}}})
            r = srv._handle({"op": "worker_cycle", "req": "w", "args": {
                "experiment": "e1", "worker": "w0", "pool_size": 2,
                "produce": True}})["result"]
            assert r["trial"] is not None
            clk.advance(31.0)
            srv.housekeeping_step()
            t = srv.inner.get("e1", r["trial"]["id"])
            assert t.status == "new", "stale sweep missed a virtual expiry"
        finally:
            srv.stop()
            set_trial_clock(prev)

    def test_recovery_grace_refreshes_restored_heartbeats(self, tmp_path):
        """Reservations restored from snapshot+WAL get their heartbeats
        re-stamped to recovery time: a sweep right after the restart does
        not free them, one a full stale timeout later does."""
        clk = VirtualClock()
        prev = set_trial_clock(clk)
        snap = str(tmp_path / "c.snap")

        def boot():
            s = CoordServer(
                snapshot_path=snap, host_algorithms=True,
                stale_timeout_s=30.0, sweep_interval_s=5.0,
                produce_coalesce_ms=0.0, wal_fsync=False,
                wal_group_ms=0.0, clock=clk, device="cpu",
            )
            s._recover()
            return s

        srv = boot()
        try:
            srv._handle({"op": "create_experiment", "req": "c", "args": {
                "config": {"name": "e1",
                           "space": {"x": "uniform(0, 1)"},
                           "algorithm": {"random": {"seed": 1}},
                           "max_trials": 4, "pool_size": 2}}})
            r = srv._handle({"op": "worker_cycle", "req": "w", "args": {
                "experiment": "e1", "worker": "w0", "pool_size": 2,
                "produce": True}})["result"]
            tid = r["trial"]["id"]
            srv._wal.sync(srv._barrier_seq("worker_cycle"))
            clk.advance(29.0)
            srv._wal._f.close()
            srv = boot()
            clk.advance(5.0 + 2.0)
            srv.housekeeping_step()
            assert srv.inner.get("e1", tid).status == "reserved"
            clk.advance(30.0)
            srv.housekeeping_step()
            assert srv.inner.get("e1", tid).status == "new"
        finally:
            srv.stop()
            set_trial_clock(prev)


def small_cfg(cls=SimConfig, **kw):
    kw.setdefault("workers", 40)
    kw.setdefault("tenants", 2)
    kw.setdefault("experiments_per_tenant", 1)
    kw.setdefault("max_trials", 16)
    kw.setdefault("seed", 0)
    return cls(**kw)


class TestSimulationSmall:
    def test_runs_to_completion_and_certifies(self):
        rep = run(small_cfg())
        assert rep.ok
        assert rep.experiments == 2
        assert rep.acked_completions == 2 * 16
        assert rep.completed_by_tenant == {"t0": 16, "t1": 16}
        assert rep.jain == 1.0
        assert rep.virtual_s < rep.config["max_virtual_s"]

    def test_same_seed_byte_identical_event_log(self, tmp_path):
        logs = []
        for i in range(2):
            path = str(tmp_path / f"ev{i}.jsonl")
            rep = run(small_cfg(
                seed=5, faults="sim_worker_death:p=0.01@1,"
                               "sim_crash_server:1@12",
                event_log=path,
            ))
            with open(path, "rb") as f:
                logs.append(f.read())
            assert rep.event_log_sha256
        assert logs[0] == logs[1]
        events = [json.loads(line) for line in logs[0].splitlines()]
        assert all("t" in e and "ev" in e for e in events)
        assert [e["t"] for e in events] == sorted(e["t"] for e in events)

    def test_different_seed_different_log(self):
        assert (run(small_cfg(seed=1)).event_log_sha256
                != run(small_cfg(seed=2)).event_log_sha256)

    def test_crash_faults_lose_no_acked_write(self):
        rep = run(small_cfg(seed=3, faults="sim_crash_server:3@8"))
        assert rep.crashes == 3
        assert rep.recoveries and all(
            r["wall_s"] >= 0 for r in rep.recoveries)
        assert rep.acked_write_losses == []
        assert rep.exactly_once_violations == []
        assert rep.ok

    def test_worker_death_and_stale_release_still_complete(self):
        rep = run(small_cfg(
            seed=4, workers=30,
            faults="sim_worker_death:p=0.05@9,sim_lost_heartbeat:p=0.1@2",
        ))
        assert rep.ok
        assert rep.acked_completions == 2 * 16
        assert rep.worker_deaths + rep.cas_rejected_completions > 0

    def test_hyperband_certifies_under_crash(self):
        rep = run(small_cfg(algos=("hyperband",), max_trials=20, seed=0,
                            faults="sim_crash_server:1@15"))
        assert rep.promotion_violations == []
        assert rep.ok

    def test_no_threads_leak_from_unstarted_server(self):
        before = {t.name for t in threading.enumerate()}
        run(small_cfg(seed=6))
        after = {t.name for t in threading.enumerate()}
        assert not {n for n in after - before if n.startswith("coord-")}

    def test_hosted_tpe_on_the_cpu_certifies(self, monkeypatch):
        """TPE hosted on ``device="cpu"`` through a coordinator crash. With
        two workers and pools of one, suggestions past its 20 initial
        points go through EI launches (with many workers a run registers
        its whole budget during the random phase: no launch at all)."""
        from metaopt_tpu_torch.sim import engine

        hosted = []
        real = engine.Simulation._finalize

        def finalize(self):
            hosted.extend(e[0].algorithm for e in self.server._producers.values())
            return real(self)

        monkeypatch.setattr(engine.Simulation, "_finalize", finalize)
        rep = run(SimConfig(workers=2, tenants=1, experiments_per_tenant=1,
                            algos=("tpe",), max_trials=32, pool_size=1,
                            seed=0, faults="sim_crash_server:1@30"))
        assert rep.ok, (rep.promotion_violations, rep.acked_write_losses)
        assert rep.acked_completions == 32 and rep.crashes == 1
        (tpe,) = hosted
        assert type(tpe).__name__ == "TPE" and str(tpe.device) == "cpu"
        assert tpe.telemetry()["kernel_launches"] > 0

    def test_without_cuda_the_simulation_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation(small_cfg())


def certify(rep):
    assert rep.promotion_violations == [], rep.promotion_violations
    assert rep.acked_write_losses == [], rep.acked_write_losses
    assert rep.exactly_once_violations == [], rep.exactly_once_violations
    assert rep.ok


class TestSmoke1k:
    """1000 workers, mixed algorithms, default chaos."""

    def test_1k_workers_mixed_algos_certify(self):
        rep = run(SimConfig(
            workers=1000, tenants=4, experiments_per_tenant=2,
            algos=("asha", "hyperband", "random", "tpe"),
            max_trials=32, seed=0, faults=DEFAULT_FAULTS,
        ))
        certify(rep)
        assert rep.acked_completions == 8 * 32
        assert rep.jain >= 0.9, rep.completed_by_tenant
        assert rep.crashes == 2  # DEFAULT_FAULTS arms two server crashes
        assert rep.wall_s < 120.0

    def test_1k_recovery_time_bounded_by_wal_length(self):
        rep = run(SimConfig(
            workers=1000, tenants=2, experiments_per_tenant=1,
            max_trials=32, seed=1, faults="sim_crash_server:3@40",
        ))
        certify(rep)
        assert len(rep.recoveries) == 3
        assert rep.recovery_s_per_10k_wal is not None
        assert rep.recovery_s_per_10k_wal < 60.0


class TestReferenceDigest:
    @pytest.mark.parametrize("workers,seed,faults", [
        (120, 0, DEFAULT_FAULTS),
        (60, 7, "sim_worker_death:p=0.02@3,sim_lost_heartbeat:p=0.05@4,"
                "sim_crash_server:2@10"),
    ])
    def test_event_log_digest_equals_reference(self, workers, seed, faults):
        kw = dict(workers=workers, tenants=2, experiments_per_tenant=2,
                  algos=("asha", "hyperband"), max_trials=24, seed=seed,
                  faults=faults)
        ours = run(SimConfig(**kw))
        theirs = RefSimulation(RefSimConfig(**kw)).run()
        assert ours.ok and theirs.ok
        assert ours.crashes == theirs.crashes >= 1
        assert ours.event_lines == theirs.event_lines
        assert ours.event_log_sha256 == theirs.event_log_sha256
        mine, ref = ours.to_dict(), theirs.to_dict()
        assert mine.keys() == ref.keys()
        for key in ("acked_completions", "dispatches", "completed_by_tenant",
                    "best_by_experiment", "virtual_s", "jain",
                    "cas_rejected_completions", "stale_released",
                    "worker_deaths", "config"):
            assert mine[key] == ref[key], key
