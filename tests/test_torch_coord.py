"""The reference's coordinator contracts (``tests/unit/test_coord.py``),
restated against the port: snapshots/resume, the pacemaker, control
signals, the event log, exactly-once retries of ``reserve`` and
``worker_cycle``, the hosted producers and the produce coalescer, the
fused worker cycle against serial serving, old-client/new-server
fallbacks, the WAL (replay, compaction, torn tails, the bare in-memory
server having none), exactly-once across restarts, restore's merge
semantics and session resumption.

The hosted algorithms run on the CPU (``CoordServer(device="cpu")``); the
reference's ``pod.py`` glue is not ported, so its two tests are not
restated.
"""

import json
import threading
import time

import pytest

from metaopt_tpu_torch.coord import CoordLedgerClient
from metaopt_tpu_torch.coord import CoordServer as _CoordServer
from metaopt_tpu_torch.ledger import Experiment, Trial
from metaopt_tpu_torch.ledger.backends import MemoryLedger


class CoordServer(_CoordServer):
    """The port's server with its hosted algorithms on the CPU."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def _client(server):
    host, port = server.address
    return CoordLedgerClient(host=host, port=port)


@pytest.fixture()
def server():
    with CoordServer() as s:
        yield s


def _trial(x, exp="exp"):
    return Trial(params={"x": x}, experiment=exp)


def _snap_experiments(state):
    """Experiment names in a snapshot, v1 (full dump) or v2 (incremental
    manifest with per-experiment sections)."""
    if int(state.get("version", 1)) >= 2:
        return set(state.get("sections", {}))
    return set(state.get("experiments", {}))


def _snap_trial_count(state, exp):
    """Live trial-doc count for ``exp`` — v2 counts mutable docs plus the
    manifest's sealed-segment rows net of dead ones."""
    if int(state.get("version", 1)) >= 2:
        sec = state.get("sections", {}).get(exp, {})
        return len(sec.get("docs", [])) + sum(
            ref["rows"] - len(ref.get("dead", []))
            for ref in sec.get("segments", [])
        )
    return len(state.get("trials", {}).get(exp, []))


class TestSnapshotResume:
    def test_roundtrip_preserves_experiments_trials_signals(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp", "max_trials": 7})
            t1, t2 = _trial(1.0), _trial(2.0)
            c.register(t1)
            c.register(t2)
            got = c.reserve("exp", "w0")
            got.transition("completed")
            got.attach_results(
                [{"name": "objective", "type": "objective", "value": 0.5}]
            )
            assert c.update_trial(got, expected_status="reserved")
            c.set_signal("exp", t2.id, "stop")
        # stop() snapshots; a fresh server restores from the same path
        with CoordServer(snapshot_path=snap) as s2:
            c2 = _client(s2)
            doc = c2.load_experiment("exp")
            assert doc["max_trials"] == 7
            trials = c2.fetch("exp")
            assert {t.id for t in trials} == {t1.id, t2.id}
            done = [t for t in trials if t.status == "completed"]
            assert len(done) == 1 and done[0].objective == 0.5
            # the signal survived: heartbeat for t2 must report stop
            c2.register_ok = c2.reserve("exp", "w1")  # reserve t2
            assert c2.heartbeat("exp", t2.id, "w1") is False

    def test_restore_is_idempotent_with_persistent_inner(self, tmp_path):
        # snapshot + file inner: restore must not duplicate existing docs
        from metaopt_tpu_torch.ledger.backends import FileLedger

        snap = str(tmp_path / "snap.json")
        inner_dir = str(tmp_path / "inner")
        with CoordServer(
            inner=FileLedger(path=inner_dir), snapshot_path=snap
        ) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
        with CoordServer(
            inner=FileLedger(path=inner_dir), snapshot_path=snap
        ) as s2:
            c2 = _client(s2)
            assert len(c2.fetch("exp")) == 1

    def test_on_demand_snapshot_op(self, server, tmp_path):
        c = _client(server)
        c.create_experiment({"name": "exp"})
        path = str(tmp_path / "manual.json")
        assert c.snapshot(path) == path
        state = json.load(open(path))
        assert "exp" in _snap_experiments(state)


class TestPacemaker:
    def test_sweeper_releases_dead_workers_reservation(self):
        with CoordServer(stale_timeout_s=0.2, sweep_interval_s=0.05) as s:
            c = _client(s)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            t = c.reserve("exp", "dead-worker")
            assert c.heartbeat("exp", t.id, "dead-worker")
            deadline = time.time() + 5
            while time.time() < deadline:
                fresh = c.get("exp", t.id)
                if fresh.status == "new":
                    break
                time.sleep(0.05)
            assert fresh.status == "new" and fresh.worker is None
            # and it is reservable again by a live worker
            again = c.reserve("exp", "live-worker")
            assert again is not None and again.id == t.id

    def test_live_heartbeat_prevents_release(self):
        with CoordServer(stale_timeout_s=0.3, sweep_interval_s=0.05) as s:
            c = _client(s)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            t = c.reserve("exp", "w0")
            for _ in range(8):
                assert c.heartbeat("exp", t.id, "w0")
                time.sleep(0.1)
            assert c.get("exp", t.id).status == "reserved"


class TestControlSignals:
    def test_stop_signal_fails_heartbeat(self, server):
        c = _client(server)
        c.create_experiment({"name": "exp"})
        c.register(_trial(1.0))
        t = c.reserve("exp", "w0")
        assert c.heartbeat("exp", t.id, "w0") is True
        c.set_signal("exp", t.id, "stop")
        assert c.heartbeat("exp", t.id, "w0") is False

    def test_signal_cleared_when_trial_finishes(self, server):
        c = _client(server)
        c.create_experiment({"name": "exp"})
        tr = _trial(1.0)
        c.register(tr)
        t = c.reserve("exp", "w0")
        c.set_signal("exp", t.id, "stop")
        t.transition("interrupted")
        assert c.update_trial(t, expected_status="reserved")
        # trial re-queued manually: signal must not haunt the retry
        t.status = "new"
        t.worker = None
        assert c.update_trial(t)
        t2 = c.reserve("exp", "w1")
        assert c.heartbeat("exp", t2.id, "w1") is True


class TestEventLog:
    def test_mutations_logged_as_jsonl(self, tmp_path):
        log_path = str(tmp_path / "events.jsonl")
        with CoordServer(event_log_path=log_path) as s:
            c = _client(s)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            t = c.reserve("exp", "w0")
            t.transition("completed")
            c.update_trial(t, expected_status="reserved")
        events = [json.loads(line) for line in open(log_path)]
        ops = [e["op"] for e in events]
        assert ops == ["create_experiment", "register", "reserve", "update_trial"]
        assert all(e["experiment"] == "exp" for e in events)


class TestConcurrency:
    def test_many_threads_never_double_reserve(self, server):
        c0 = _client(server)
        c0.create_experiment({"name": "exp"})
        for i in range(40):
            c0.register(_trial(float(i)))

        wins = []
        lock = threading.Lock()

        def grab(worker):
            c = _client(server)  # own connection per thread
            while True:
                t = c.reserve("exp", worker)
                if t is None:
                    return
                with lock:
                    wins.append(t.id)

        threads = [
            threading.Thread(target=grab, args=(f"w{i}",)) for i in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(wins) == 40 and len(set(wins)) == 40

    def test_client_reconnects_after_connection_drop(self, server):
        c = _client(server)
        c.create_experiment({"name": "exp"})
        c._sock().close()  # simulate a dropped connection
        assert c.load_experiment("exp") is not None

    def test_retried_reserve_is_exactly_once(self, server):
        """A re-delivered request (same req id) must not re-execute the op.

        This is the "reserve executed, reply lost to the connection drop"
        scenario: the client's retry re-sends with the same request id and
        must get the SAME trial back, leaving only one reservation.
        """
        import socket as _socket

        from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg

        c = _client(server)
        c.create_experiment({"name": "exp"})
        c.register(_trial(1.0))
        c.register(_trial(2.0))

        host, port = server.address
        msg = {
            "op": "reserve",
            "args": {"experiment": "exp", "worker": "w0"},
            "req": "fixed-req-id",
        }
        replies = []
        for _ in range(2):  # two deliveries on two fresh connections
            s = _socket.create_connection((host, port))
            send_msg(s, msg)
            replies.append(recv_msg(s))
            s.close()
        assert replies[0]["ok"] and replies[1]["ok"]
        assert replies[0]["result"]["id"] == replies[1]["result"]["id"]
        reserved = [t for t in c.fetch("exp") if t.status == "reserved"]
        assert len(reserved) == 1

    def test_concurrent_snapshots_never_corrupt(self, server, tmp_path):
        snap = str(tmp_path / "snap.json")
        c = _client(server)
        c.create_experiment({"name": "exp"})
        for i in range(20):
            c.register(_trial(float(i)))

        threads = [
            threading.Thread(target=server.snapshot, args=(snap,))
            for _ in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        state = json.load(open(snap))  # must parse — no interleaved writes
        assert _snap_trial_count(state, "exp") == 20


class TestExperimentOverCoord:
    def test_experiment_workflow_end_to_end(self, server):
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.space import build_space
        from metaopt_tpu_torch.worker import workon

        c = _client(server)
        exp = Experiment(
            "quad",
            c,
            space=build_space({"x": "uniform(-5, 5)"}),
            max_trials=12,
            pool_size=3,
            algorithm={"random": {"seed": 1}},
        ).configure()
        stats = workon(exp, InProcessExecutor(lambda p: (p["x"] - 1) ** 2))
        assert stats.completed == 12
        assert exp.stats["best"]["objective"] >= 0.0


class TestHostedProducer:
    """Coordinator-hosted suggestion — the north star's centralized surrogate."""

    def _exp(self, c, name="hosted", algo=None, max_trials=12, pool_size=3):
        from metaopt_tpu_torch.space import build_space

        return Experiment(
            name, c, space=build_space({"x": "uniform(-5, 5)"}),
            max_trials=max_trials, pool_size=pool_size,
            algorithm=algo or {"random": {"seed": 1}},
        ).configure()

    def test_produce_registers_on_single_hosted_algo(self, server):
        c = _client(server)
        self._exp(c)
        out = c.produce("hosted", pool_size=3)
        assert out["registered"] == 3
        assert len(c.fetch("hosted", "new")) == 3
        c.produce("hosted", pool_size=3)
        # one hosted producer instance, not one per client call
        assert list(server._producers) == ["hosted"]

    def test_produce_unknown_experiment_raises(self, server):
        c = _client(server)
        with pytest.raises(KeyError):
            c.produce("nope")

    def test_produce_rejected_when_hosting_disabled(self):
        with CoordServer(host_algorithms=False) as s:
            c = _client(s)
            self._exp(c)
            from metaopt_tpu_torch.coord.client_backend import CoordRPCError

            with pytest.raises((ValueError, CoordRPCError)):
                c.produce("hosted")

    def test_workon_coord_mode_end_to_end(self, server):
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.worker import workon

        c = _client(server)
        exp = self._exp(c, name="coordmode")
        stats = workon(
            exp, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
            producer_mode="coord",
        )
        assert stats.completed == 12
        assert stats.producer_timings.get("remote") == 1
        # the worker never fit a local algorithm; the hosted one did the work
        assert "coordmode" in server._producers

    def test_tpe_hosted_single_fit_stream(self, server):
        """N workers against one hosted TPE: every suggestion comes from the
        same fitted instance and duplicates are ~0 (ledger saw no drops)."""
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.worker import workon

        c = _client(server)
        exp = self._exp(
            c, name="tpe-hosted",
            algo={"tpe": {"seed": 3, "n_initial_points": 4}},
            max_trials=10, pool_size=2,
        )
        errs = []

        def run(i):
            try:
                cli = _client(server)
                e = Experiment("tpe-hosted", cli).configure()
                workon(
                    e, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
                    worker_id=f"w{i}", producer_mode="coord",
                )
            except Exception as exc:  # pragma: no cover
                errs.append(exc)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs
        done = c.fetch("tpe-hosted", "completed")
        assert len(done) >= 10
        # exactly one hosted algorithm served all three workers
        assert list(server._producers) == ["tpe-hosted"]
        prod, lock = server._producers["tpe-hosted"]
        algo = prod.algorithm
        # Observation lag: while suggests are still possible the lag is
        # bounded by the in-flight window, but once the registration
        # budget is exhausted, passive algorithms (no judge/suspend
        # verdicts consult the fit between produces) skip the no-op
        # produce legs entirely (worker_cycle ``algo_passive``), so
        # tail-of-run completions legitimately stay unobserved until the
        # next real produce. Everything observed must still be a real
        # completion...
        assert set(algo._observed) <= {t.id for t in done}
        # ...and one more produce cycle drains the stream
        # deterministically: all workers have joined, so nothing is in
        # flight and every completed trial id must land in the surrogate
        # (produce observes before its budget check, even at max_trials).
        with lock:
            prod.produce()
        assert {t.id for t in done} <= set(algo._observed)

    def test_hosted_asha_promotes_rungs(self, server):
        """Multi-fidelity bookkeeping lives pod-global on the coordinator:
        three workers drive one hosted ASHA and promotions reach the top
        rung (the north star's centralized rung table)."""
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.space import build_space
        from metaopt_tpu_torch.worker import workon

        c = _client(server)
        Experiment(
            "asha-hosted", c,
            space=build_space({"x": "uniform(0, 1)",
                               "epochs": "fidelity(1, 4, base=2)"}),
            max_trials=32, pool_size=2,
            algorithm={"asha": {"seed": 2, "reduction_factor": 2}},
        ).configure()
        errs = []

        def run(i):
            try:
                cli = _client(server)
                e = Experiment("asha-hosted", cli).configure()
                workon(
                    e, InProcessExecutor(
                        lambda p: p["x"] + 1.0 / p["epochs"]
                    ),
                    worker_id=f"aw{i}", producer_mode="coord",
                )
            except Exception as exc:  # pragma: no cover
                errs.append(exc)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs
        done = c.fetch("asha-hosted", "completed")
        assert len(done) >= 32
        budgets = {t.params.get("epochs") for t in done}
        assert max(budgets) >= 2, f"no promotion happened: {budgets}"
        # the single hosted instance holds the pod-global rung table
        algo = server._producers["asha-hosted"][0].algorithm
        table = getattr(algo, "rung_table", None)
        assert table, "hosted ASHA has no rung occupancy"

    def test_hosted_judge_roundtrip(self, server):
        c = _client(server)
        self._exp(c, name="judged", algo={"random": {"seed": 5}})
        t = Trial(params={"x": 1.0}, experiment="judged")
        # random's judge is a no-op → None over RPC
        assert c.judge("judged", t, [{"name": "loss", "type": "objective",
                                      "value": 1.0}]) is None

    def test_hosted_state_survives_restart_by_observe_replay(self, tmp_path):
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.worker import workon

        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            exp = self._exp(c, name="resume", max_trials=6)
            workon(exp, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
                   producer_mode="coord", worker_trials=3)
            s1.snapshot(snap)
        with CoordServer(snapshot_path=snap) as s2:
            c2 = _client(s2)
            assert s2._producers == {}  # fresh process, no hosted state yet
            exp2 = Experiment("resume", c2).configure()
            workon(exp2, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
                   producer_mode="coord")
            done = c2.fetch("resume", "completed")
            assert len(done) >= 6
            # the rebuilt hosted algorithm replayed the restored completions
            algo = s2._producers["resume"][0].algorithm
            assert len(algo._observed) >= 3


class TestProduceCoalescing:
    """Group-commit produce: concurrent RPCs share ONE suggest cycle, and
    any grouping of requests at the same fit replays the IDENTICAL
    suggestion stream (pool p of a batched launch is keyed
    fold_in(fit_key, count + p) — the positions sequential serving uses)."""

    SPACE = {"x": "uniform(-5, 5)", "c": "choices(['a', 'b'])"}
    ALGO = {"tpe": {"seed": 11, "n_initial_points": 2, "pool_prefetch": 4}}

    def _seeded_exp(self, c, name):
        from metaopt_tpu_torch.space import build_space

        exp = Experiment(
            name, c, space=build_space(self.SPACE), max_trials=64,
            pool_size=2, algorithm=self.ALGO,
        ).configure()
        # past the random phase: the streams compared below must come from
        # the surrogate kernel, where PRNG-position bookkeeping lives
        for i, x in enumerate([-4.0, -2.0, 0.0, 1.0, 3.0]):
            t = exp.make_trial({"x": x, "c": "a"})
            t.transition("reserved")
            t.attach_results(
                [{"name": "o", "type": "objective", "value": (x - 1) ** 2}]
            )
            t.transition("completed")
            c.register(t)
        return exp

    def _registered_stream(self, c, name):
        return [(t.params["x"], t.params["c"]) for t in c.fetch(name, "new")]

    def test_concurrent_produce_coalesces_into_one_cycle(self):
        with CoordServer(produce_coalesce_ms=300.0) as s:
            c = _client(s)
            self._seeded_exp(c, "co")
            n_clients = 4
            clients = [_client(s) for _ in range(n_clients)]
            for cli in clients:
                cli.ping()  # connect before the barrier, not inside it
            barrier = threading.Barrier(n_clients)
            results = [None] * n_clients

            def call(i):
                barrier.wait()
                results[i] = clients[i].produce("co", pool_size=2,
                                                worker=f"w{i}")

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert all(r is not None for r in results)
            # all four requests landed inside the window: one combined
            # cycle registered sum(pool_size) trials and every member got
            # the group total
            assert max(r["coalesced"] for r in results) == n_clients
            assert {r["registered"] for r in results} == {2 * n_clients}
            assert len(c.fetch("co", "new")) == 2 * n_clients
            coalesced_stream = self._registered_stream(c, "co")

        # same experiment, window disabled, strictly serial requests: the
        # registered suggestion stream must be BIT-identical — coalescing
        # changes latency, never the stream
        with CoordServer(produce_coalesce_ms=0.0) as s2:
            c2 = _client(s2)
            self._seeded_exp(c2, "co")
            for i in range(n_clients):
                out = c2.produce("co", pool_size=2, worker=f"w{i}")
                assert out["coalesced"] == 1
            serial_stream = self._registered_stream(c2, "co")
        assert coalesced_stream == serial_stream

    def test_window_zero_degrades_to_per_request_cycles(self):
        with CoordServer(produce_coalesce_ms=0.0) as s:
            c = _client(s)
            self._seeded_exp(c, "solo")
            out = c.produce("solo", pool_size=3)
            assert out["coalesced"] == 1
            assert out["registered"] == 3

    def test_prefetch_depth_plumbed_and_pool_rearmed_after_cycle(self):
        # CoordServer(suggest_prefetch_depth=N) applies to hosted algos
        # that mix in SuggestAhead, and the coalescer re-arms the pool
        # after every cycle so the NEXT produce leg answers from memory
        with CoordServer(suggest_prefetch_depth=2) as s:
            c = _client(s)
            self._seeded_exp(c, "ahead")
            out = c.produce("ahead", pool_size=2)
            assert out["registered"] >= 1
            algo = s._producers["ahead"][0].algorithm
            assert algo.suggest_prefetch_depth == 2
            algo.drain_suggest_ahead()
            tel = algo.suggest_ahead_telemetry()
            assert tel["ahead_launches"] >= 1
            assert len(algo._prefetch) > 0  # a pool is banked for the next leg

    def test_depth_default_leaves_hosted_algo_untouched(self):
        with CoordServer() as s:
            c = _client(s)
            self._seeded_exp(c, "plain")
            c.produce("plain", pool_size=2)
            algo = s._producers["plain"][0].algorithm
            assert algo.suggest_prefetch_depth == 1


class TestDeleteExperiment:
    def test_delete_rpc_clears_docs_producer_and_signals(self, server):
        c = _client(server)
        c.create_experiment({
            "name": "exp", "space": {"x": "uniform(0, 1)"},
            "algorithm": {"random": {"seed": 0}}, "max_trials": 5,
        })
        c.register(_trial(0.5))
        t = c.reserve("exp", "w1")
        c.set_signal("exp", t.id, "stop")
        # hosted producer materializes
        c.produce("exp", 1)
        assert c.delete_experiment("exp") is True
        assert c.load_experiment("exp") is None
        assert c.fetch("exp") == []
        assert c.delete_experiment("exp") is False  # already gone
        with server._producers_guard:
            assert "exp" not in server._producers
        assert not any(k[0] == "exp" for k in server._signals)

    def test_delete_vs_cold_produce_never_deadlocks(self, server):
        # regression: delete took _producers_guard INSIDE _lock while
        # _hosted_producer takes _lock inside _producers_guard — concurrent
        # cold produce + delete could AB-BA wedge the whole coordinator
        c = _client(server)

        def spin(tag, op):
            cc = _client(server)
            for i in range(15):
                try:
                    op(cc, i)
                except Exception:
                    pass  # missing experiment etc. — liveness is the test

        def produce_op(cc, i):
            cc.create_experiment({
                "name": "churn", "space": {"x": "uniform(0, 1)"},
                "algorithm": {"random": {"seed": 0}}, "max_trials": 99,
            })
            cc.produce("churn", 2)

        def delete_op(cc, i):
            cc.delete_experiment("churn")

        # daemon: a regression must FAIL the test, not hang pytest at exit
        threads = [
            threading.Thread(target=spin, args=("p", produce_op), daemon=True),
            threading.Thread(target=spin, args=("d", delete_op), daemon=True),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "coordinator wedged"
        assert c.ping()["pong"]  # still serving

    def test_delete_survives_restart(self, tmp_path):
        # restore() merges snapshot docs back in — a delete must persist a
        # fresh snapshot or the experiment resurrects after a crash
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap, snapshot_interval_s=3600) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp", "max_trials": 5})
            c.register(_trial(0.5))
            c.snapshot()  # periodic snapshot captured the pre-delete state
            assert c.delete_experiment("exp") is True
            # crash here (no orderly stop-snapshot): simulate by not
            # letting the context manager's stop() run a final snapshot
            s1.snapshot_path = None
        with CoordServer(snapshot_path=snap) as s2:
            c2 = _client(s2)
            assert c2.load_experiment("exp") is None
            assert c2.fetch("exp") == []


class TestUnavailableContract:
    def test_dead_coordinator_raises_typed_error(self):
        """A coordinator that never answers surfaces as
        CoordUnavailableError — NOT a bare BrokenPipeError/OSError: the
        CLI treats BrokenPipeError as "stdout pipe closed, exit 0", and a
        hard infrastructure failure must never exit 0."""
        import socket as _socket

        from metaopt_tpu_torch.coord.client_backend import (
            CoordLedgerClient,
            CoordUnavailableError,
        )

        # hold the port bound WITHOUT listen() for the whole test:
        # connects get a deterministic ECONNREFUSED and no other process
        # can claim the port in between (a bind-then-close probe would
        # leave a TOCTOU window where a foreign listener turns this into
        # an indefinite recv hang instead of a refusal)
        anchor = _socket.socket()
        try:
            anchor.bind(("127.0.0.1", 0))
            port = anchor.getsockname()[1]
            c = CoordLedgerClient(host="127.0.0.1", port=port,
                                  connect_timeout_s=0.2,
                                  reconnect_window_s=0.5)
            with pytest.raises(CoordUnavailableError) as err:
                c.ping()
        finally:
            anchor.close()
        assert not isinstance(err.value, BrokenPipeError)
        assert "unreachable" in str(err.value)


class TestWorkerCycle:
    """The fused worker_cycle op: serial-sequence equivalence (including
    the deferred ``complete`` push leg), rolling-upgrade fallback in both
    directions, exactly-once retry, and snapshot consistency under the
    sharded per-experiment locks."""

    def _drive(self, server, name, serial):
        """Scripted workon-shaped loop against one server; returns the
        reserved (id, x) stream and the final ledger state."""
        from metaopt_tpu_torch.space import build_space

        c = _client(server)
        if serial:
            # a pre-worker_cycle capability probe result: forces the
            # serial composition without a version fork in the loop
            c._caps = ("count", "fetch_completed_since")
        Experiment(
            name, c, space=build_space({"x": "uniform(-5, 5)"}),
            max_trials=6, pool_size=2,
            algorithm={"random": {"seed": 7}},
        ).configure()
        stream, complete = [], None
        for _ in range(40):
            out = c.worker_cycle(name, "w0", pool_size=2, complete=complete)
            complete = None
            assert out["fused"] is not serial
            t = out["trial"]
            if t is None:
                if out["counts"]["completed"] >= 6:
                    break
                continue
            stream.append((t.id, t.params["x"]))
            t.attach_results([{
                "name": "objective", "type": "objective",
                "value": (t.params["x"] - 1) ** 2,
            }])
            t.transition("completed")
            # the steady-state fast path: the terminal update rides in on
            # the NEXT cycle instead of costing its own round-trip
            complete = {"trial": t.to_dict(),
                        "expected_status": "reserved",
                        "expected_worker": "w0"}
        else:
            pytest.fail("scripted loop never finished")
        final = sorted((t.id, t.status) for t in c.fetch(name))
        return stream, final

    def test_fused_stream_bit_identical_to_serial_sequence(self):
        """Same seed, two fresh servers: the fused op must reserve the
        exact same suggestion stream (trial ids ARE param hashes, so id
        equality is param equality) and leave identical ledger state."""
        with CoordServer() as s1:
            fused_stream, fused_final = self._drive(s1, "wc", serial=False)
        with CoordServer() as s2:
            serial_stream, serial_final = self._drive(s2, "wc", serial=True)
        assert fused_stream == serial_stream
        assert fused_final == serial_final
        assert len(fused_final) == 6
        assert all(st == "completed" for _, st in fused_final)

    def test_new_client_old_server_falls_back_serially(self):
        """Rolling upgrade, server behind: ping doesn't advertise the op,
        so the client composes the cycle from serial RPCs and never sends
        worker_cycle at all."""
        from metaopt_tpu_torch.coord import server as server_mod
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.space import build_space
        from metaopt_tpu_torch.worker import workon

        class OldServer(CoordServer):
            def _dispatch(self, op, a):
                assert op != "worker_cycle"
                r = super()._dispatch(op, a)
                if op == "ping":
                    r["caps"] = [c for c in server_mod.CAPS
                                 if c != "worker_cycle"]
                return r

            def _handle(self, msg, wire="v1"):
                assert msg.get("op") != "worker_cycle"
                return super()._handle(msg, wire)

        with OldServer() as s:
            c = _client(s)
            exp = Experiment(
                "old-srv", c, space=build_space({"x": "uniform(-5, 5)"}),
                max_trials=8, pool_size=2,
                algorithm={"random": {"seed": 3}},
            ).configure()
            stats = workon(
                exp, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
                producer_mode="coord",
            )
            assert stats.completed == 8
            assert not c._has_cap("worker_cycle")

    def test_old_client_new_server_serial_ops_still_served(self, server):
        """Rolling upgrade, client behind: a client that never learned
        the op keeps working against a fused-capable server via the
        original op sequence."""
        from metaopt_tpu_torch.executor import InProcessExecutor
        from metaopt_tpu_torch.space import build_space
        from metaopt_tpu_torch.worker import workon

        sent = []
        host, port = server.address

        class OldClient(CoordLedgerClient):
            def _call(self, op, **args):
                assert op != "worker_cycle"
                sent.append(op)
                return super()._call(op, **args)

        c = OldClient(host=host, port=port)
        c._caps = ("count", "fetch_completed_since")  # pre-upgrade probe
        exp = Experiment(
            "old-cli", c, space=build_space({"x": "uniform(-5, 5)"}),
            max_trials=8, pool_size=2,
            algorithm={"random": {"seed": 3}},
        ).configure()
        stats = workon(
            exp, InProcessExecutor(lambda p: (p["x"] - 1) ** 2),
            producer_mode="coord",
        )
        assert stats.completed == 8
        assert "reserve" in sent and "produce" in sent

    def test_retried_worker_cycle_is_exactly_once(self, server):
        """Re-delivered worker_cycle (same req id) must not re-execute:
        same reply, one produce (one pool registered), one reservation,
        and the embedded complete leg applied once."""
        import socket as _socket

        from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg
        from metaopt_tpu_torch.space import build_space

        c = _client(server)
        Experiment(
            "wc-retry", c, space=build_space({"x": "uniform(-5, 5)"}),
            max_trials=8, pool_size=2,
            algorithm={"random": {"seed": 1}},
        ).configure()
        # a reserved trial whose terminal push will ride in the retried
        # cycle — double delivery must not double-apply it either
        first = c.worker_cycle("wc-retry", "w0", pool_size=2)["trial"]
        first.attach_results([{
            "name": "objective", "type": "objective", "value": 0.5,
        }])
        first.transition("completed")

        host, port = server.address
        msg = {
            "op": "worker_cycle",
            "args": {
                "experiment": "wc-retry", "worker": "w0", "pool_size": 2,
                "complete": {"trial": first.to_dict(),
                             "expected_status": "reserved",
                             "expected_worker": "w0"},
            },
            "req": "wc-fixed-req",
        }
        replies = []
        for _ in range(2):  # two deliveries on two fresh connections
            s = _socket.create_connection((host, port))
            send_msg(s, msg)
            replies.append(recv_msg(s))
            s.close()
        assert replies[0]["ok"] and replies[1]["ok"]
        r0, r1 = replies[0]["result"], replies[1]["result"]
        assert r0 == r1  # byte-for-byte replayed, not re-executed
        assert r0["completed_ok"] is True
        assert r0["trial"]["id"] != first.id
        trials = c.fetch("wc-retry")
        assert len([t for t in trials if t.status == "reserved"]) == 1
        assert len([t for t in trials if t.status == "completed"]) == 1

    def test_concurrent_fetch_sees_consistent_snapshot(self, server):
        """Readers racing a writer under the sharded per-experiment locks:
        every fetch must be an internally consistent snapshot — all 20
        trials present exactly once, every status valid."""
        c = _client(server)
        c.create_experiment({"name": "snap"})
        for i in range(20):
            c.register(_trial(float(i), exp="snap"))

        errors = []
        stop = threading.Event()

        def mutate():
            cm = _client(server)
            try:
                while True:
                    t = cm.reserve("snap", "wm")
                    if t is None:
                        break
                    t.attach_results([{
                        "name": "objective", "type": "objective",
                        "value": t.params["x"],
                    }])
                    t.transition("completed")
                    assert cm.update_trial(t, expected_status="reserved")
            except Exception as err:  # pragma: no cover - failure path
                errors.append(f"writer: {err!r}")
            finally:
                stop.set()

        def read(k):
            cr = _client(server)
            try:
                while not stop.is_set():
                    snap = [(t.id, t.status) for t in cr.fetch("snap")]
                    ids = [tid for tid, _ in snap]
                    if len(ids) != 20 or len(set(ids)) != 20:
                        errors.append(f"reader{k}: torn snapshot {len(ids)}")
                        return
                    bad = [s for _, s in snap
                           if s not in ("new", "reserved", "completed")]
                    if bad:
                        errors.append(f"reader{k}: bad statuses {bad}")
                        return
            except Exception as err:  # pragma: no cover - failure path
                errors.append(f"reader{k}: {err!r}")

        threads = [threading.Thread(target=mutate)]
        threads += [threading.Thread(target=read, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        assert all(t.status == "completed" for t in c.fetch("snap"))


def _crash(server):
    """Simulate kill -9: skip the shutdown snapshot so the WAL is the only
    record of everything since the last (possibly absent) snapshot."""
    server.snapshot_path = None
    server.stop()


class TestWALDurability:
    """Write-ahead log: replay, compaction, torn tails, recovery grace."""

    def test_wal_replays_without_snapshot(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp", "max_trials": 7})
            for x in (1.0, 2.0, 3.0):
                c.register(_trial(x))
            got = c.reserve("exp", "w0")
            got.transition("completed")
            got.attach_results(
                [{"name": "objective", "type": "objective", "value": 0.25}]
            )
            assert c.update_trial(got, expected_status="reserved")
            c.set_signal("exp", got.id, "stop")
            _crash(s1)
        import os
        assert not os.path.exists(snap)  # crash == no shutdown snapshot
        assert os.path.getsize(snap + ".wal") > 0
        with CoordServer(snapshot_path=snap) as s2:
            c2 = _client(s2)
            assert c2.load_experiment("exp")["max_trials"] == 7
            assert c2.count("exp") == 3
            assert c2.count("exp", status="completed") == 1
            done = [t for t in c2.fetch("exp") if t.status == "completed"]
            assert done[0].objective == 0.25
            assert s2._signals.get(("exp", done[0].id)) == "stop"

    def test_snapshot_compacts_wal(self, tmp_path):
        import os
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s:
            c = _client(s)
            c.create_experiment({"name": "exp"})
            for x in range(5):
                c.register(_trial(float(x)))
            assert os.path.getsize(snap + ".wal") > 0
            c.snapshot(snap)
            # everything up to the snapshot's wal_seq is dropped from disk
            assert os.path.getsize(snap + ".wal") == 0
            assert json.load(open(snap))["wal_seq"] > 0
        # clean stop: snapshot again + compact; restart from snapshot alone
        with CoordServer(snapshot_path=snap) as s2:
            assert _client(s2).count("exp") == 5

    def test_torn_tail_truncated_and_acked_state_survives(self, tmp_path):
        import os
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            c.register(_trial(2.0))
            _crash(s1)
        wal = snap + ".wal"
        good = os.path.getsize(wal)
        with open(wal, "ab") as f:  # half-written record from a kill -9
            f.write(b"deadbeef {\"op\": \"put_trial\", \"tru")
        with CoordServer(snapshot_path=snap) as s2:
            assert _client(s2).count("exp") == 2  # acked writes intact
        # recovery physically truncated the torn tail, then compacted the
        # replayed prefix into the post-recovery snapshot
        assert os.path.getsize(wal) == 0
        assert _snap_experiments(json.load(open(snap)))

    def test_recovery_refreshes_reserved_heartbeats(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            got = c.reserve("exp", "w0")
            assert got is not None
            _crash(s1)
        time.sleep(0.3)  # downtime that must NOT count against the lease
        with CoordServer(snapshot_path=snap) as s2:
            (t,) = [t for t in _client(s2).fetch("exp")
                    if t.status == "reserved"]
            assert time.time() - t.heartbeat < 0.25

    def test_bare_in_memory_server_has_no_wal(self, server):
        assert server.wal_path is None
        assert server._wal is None
        r = _client(server)._call("ping")
        assert r["durable"] is False


class TestExactlyOnceAcrossRestart:
    """A retry whose original ack died with the server is answered from the
    journaled reply cache — never re-executed."""

    def _raw(self, server, msg):
        import socket as _socket
        from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg
        host, port = server.address
        with _socket.create_connection((host, port)) as sk:
            send_msg(sk, msg)
            return recv_msg(sk)

    def test_reserve_retry_replayed_from_journaled_reply(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        req = {"op": "reserve", "req": "retry-1",
               "args": {"experiment": "exp", "worker": "w0"}}
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp"})
            c.register(_trial(1.0))
            c.register(_trial(2.0))
            first = self._raw(s1, req)
            assert first["ok"] and first["result"] is not None
            _crash(s1)
        with CoordServer(snapshot_path=snap) as s2:
            second = self._raw(s2, req)
            assert second == first  # same trial, from the journaled cache
            assert _client(s2).count("exp", status="reserved") == 1

    def test_worker_cycle_retry_replayed_from_journaled_reply(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        req = {"op": "worker_cycle", "req": "cycle-retry-1",
               "args": {"experiment": "exp", "worker": "w0",
                        "produce": False}}
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({
                "name": "exp", "space": {"x": "uniform(0, 10)"},
                "algorithm": {"random": {"seed": 0}}, "max_trials": 5,
            })
            c.register(_trial(1.0))
            c.register(_trial(2.0))
            first = self._raw(s1, req)
            assert first["ok"] and first["result"]["trial"] is not None
            _crash(s1)
        with CoordServer(snapshot_path=snap) as s2:
            second = self._raw(s2, req)
            assert second == first
            assert _client(s2).count("exp", status="reserved") == 1


class TestRestoreMergeSemantics:
    """Pin restore()'s conservative merge: it only registers trials MISSING
    from the inner ledger and never advances an existing trial's status —
    the live ledger (e.g. a shared FileLedger that outlived the snapshot)
    is always at least as new as the snapshot."""

    def test_restore_never_advances_existing_trial_status(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        with CoordServer(snapshot_path=snap) as s1:
            c = _client(s1)
            c.create_experiment({"name": "exp", "max_trials": 5})
            c.register(_trial(1.0))  # 'new' in the snapshot
            c.register(_trial(2.0))
        # live ledger where the same trial has SINCE completed
        s2 = CoordServer()
        s2.inner.create_experiment({"name": "exp", "max_trials": 5})
        done = _trial(1.0)  # same params => same deterministic id
        done.transition("reserved")
        done.transition("completed")
        s2.inner.register(done)
        s2.restore(snap)
        docs = {t.id: t for t in s2.inner.fetch("exp")}
        assert len(docs) == 2  # missing trial registered, no duplicates
        assert docs[done.id].status == "completed"  # never rolled back
        assert docs[_trial(2.0).id].status == "new"


class TestClientResumption:
    def test_jitter_bounds_and_growth(self):
        from metaopt_tpu_torch.coord.client_backend import decorrelated_jitter
        d = 0.0
        seen = []
        for _ in range(50):
            d = decorrelated_jitter(d, base_s=0.05, cap_s=2.0)
            assert 0.05 <= d <= 2.0
            seen.append(d)
        assert len(set(seen)) > 1  # jittered, not a fixed schedule

    def test_reconnect_reasserts_reservation_after_restart(self, tmp_path):
        snap = str(tmp_path / "snap.json")
        s1 = CoordServer(snapshot_path=snap)
        s1.start()
        host, port = s1.address
        c = CoordLedgerClient(host=host, port=port, reconnect_window_s=10.0)
        c.create_experiment({"name": "exp"})
        c.register(_trial(1.0))
        got = c.reserve("exp", "w0")
        assert got is not None
        inc1 = c._incarnation
        assert ("exp", got.id) in c._live
        s1.stop()  # clean stop: snapshot + WAL compaction
        # restart on the SAME port: reservation survives via snapshot,
        # and the client re-asserts it on first reconnected call
        s2 = CoordServer(host=host, port=port, snapshot_path=snap)
        s2.start()
        try:
            assert c.count("exp", status="reserved") == 1
            assert c._incarnation != inc1
            assert c.heartbeat("exp", got.id, "w0") is True
            got.transition("completed")
            assert c.update_trial(got, expected_status="reserved")
            assert ("exp", got.id) not in c._live
        finally:
            s2.stop()


class TestPutTrialUpsert:
    def test_put_trial_registers_then_overwrites(self):
        led = MemoryLedger()
        led.create_experiment({"name": "exp"})
        t = _trial(1.0)
        led.put_trial(t)
        assert led.count("exp") == 1
        t2 = _trial(1.0)
        t2.transition("reserved")
        t2.transition("completed")
        led.put_trial(t2)  # same id: unconditional overwrite, no error
        (doc,) = led.fetch("exp")
        assert doc.status == "completed"


# -- the port's own: the device and the batched hunt on a coordinator ----


class TestPortDevice:
    def test_hosting_defaults_to_cuda_and_raises_without_it(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _CoordServer()
        # a server that hosts nothing needs no device
        assert _CoordServer(host_algorithms=False).device is None

    def test_hosted_algorithms_take_the_servers_device_unstored(self, server):
        from metaopt_tpu_torch.space import build_space

        c = _client(server)
        cfg = {"name": "dev", "space": build_space({"x": "uniform(0, 1)"}).configuration,
               "algorithm": {"tpe": {"seed": 0}}, "max_trials": 4, "version": 1}
        c.create_experiment(cfg)
        c.produce("dev", pool_size=1)
        algo = server._producers["dev"][0].algorithm
        assert str(algo.device) == "cpu"
        assert c.load_experiment("dev")["algorithm"] == {"tpe": {"seed": 0}}
        assert "device" not in algo.configuration["tpe"]


def test_batched_workon_through_the_coordinator(server):
    """``_workon_batched``'s fused path: pools reserved through
    ``worker_cycle``, their results pushed back in one multi-trial
    ``complete`` leg; every trial completed once."""
    from metaopt_tpu_torch.executor import BatchedExecutor
    from metaopt_tpu_torch.space import build_space
    from metaopt_tpu_torch.worker import workon

    space = build_space({"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"})
    c = _client(server)
    c.create_experiment({"name": "pool", "space": space.configuration,
                         "algorithm": {"random": {"seed": 2}}, "max_trials": 12,
                         "pool_size": 4, "version": 1})
    exp = Experiment("pool", c).configure()
    ex = BatchedExecutor(lambda cols: (cols["x"] - 1.0) ** 2 + cols["y"] ** 2, space,
                         device="cpu")
    stats = workon(exp, ex, worker_id="b0", producer_mode="coord", batch_size=4)
    done = c.fetch("pool", "completed")
    assert stats.completed == len(done) == 12
    assert len({t.id for t in done}) == 12
    assert all(t.objective == pytest.approx((t.params["x"] - 1) ** 2 + t.params["y"] ** 2)
               for t in done)
    assert stats.producer_timings["fused_cycles"] >= 3
