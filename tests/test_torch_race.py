"""``race`` on the port: the detector against the reference's, and the port's
own clean gate on the CPU.

* **The engine.** Toy workloads over a monitored ``Box`` prove the
  happens-before edges (fork/join, lock release→acquire, Event set→wait)
  suppress reports and that unordered unlocked writes give one MTR101 with
  both stacks (``tests/unit/test_race_detector.py``, restated).
* **Fixtures.** ``tests/torch_fixtures/race/`` is a copy of the reference's
  ``tests/unit/race_fixtures/``: the seeded WAL-close race and the MOTPE
  inversion are rediscovered, with the same rule, symbol and detail as the
  reference's detector reports on the same schedule.
* **Framework locks.** A lock that PyTorch creates inside the instrumented
  region still orders accesses but never enters the lock-order graph.
* **The clean gate.** MTR001 over ``metaopt_tpu_torch`` is clean, ``race
  --suite all`` on the CPU exits 0, and the chaos-length variant is
  ``slow``-marked, as the reference marks its own. The two device legs
  (two batched workers sharing one executor; the fuser's bucket launches
  against the RPC threads) run on the CPU here and on the card in
  ``chip_smoke.py``'s ``[analysis]``.
"""

import importlib.util
import json
import os
import socket
import threading
import time

import pytest

from metaopt_tpu.analysis import dynrace as ref_dynrace
from metaopt_tpu_torch.analysis import dynrace, suites
from metaopt_tpu_torch.analysis.runner import (
    DEFAULT_RACE_BASELINE, diff_baseline, load_baseline, race_main, run_race, run_race_leg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "torch_fixtures", "race")


def _load(name):
    """Import a race fixture standalone (fresh classes per test)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_race_fixture_{name}", os.path.join(FIXDIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Box:
    def __init__(self):
        self.val = 0


def _spin(flag, key):
    while not flag[key]:
        time.sleep(0.0005)


def _two_writers(pkg, ordered):
    """Two threads write ``Box.val``; ``ordered`` puts an Event edge between
    them. Returns the runtime's findings."""
    rt = pkg.RaceRuntime({Box: frozenset({"val"})}, root=REPO)
    with pkg.instrument(rt):
        b, ev, flag = Box(), threading.Event(), {"first": False}

        def w1():
            b.val = 1
            ev.set() if ordered else flag.__setitem__("first", True)

        def w2():
            ev.wait() if ordered else _spin(flag, "first")
            b.val = 2

        ts = [threading.Thread(target=w1), threading.Thread(target=w2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return rt.findings()


# -- the engine ----------------------------------------------------------------
def test_fork_join_and_lock_edges_order_accesses():
    rt = dynrace.RaceRuntime({Box: frozenset({"val"})}, root=REPO)
    with dynrace.instrument(rt):
        b, lk = Box(), threading.Lock()

        def child():
            with lk:
                b.val = 1

        t = threading.Thread(target=child)
        t.start()
        t.join()
        assert b.val == 1
        with lk:
            b.val = 2
    assert rt.findings() == []


@pytest.mark.parametrize("pkg", [ref_dynrace, dynrace], ids=["reference", "port"])
def test_an_event_edge_orders_and_a_spin_does_not(pkg):
    assert _two_writers(pkg, ordered=True) == []
    races = [f for f in _two_writers(pkg, ordered=False) if f.rule == "MTR101"]
    assert len(races) == 1
    assert races[0].symbol == "Box.val" and "write/write" in races[0].message
    assert races[0].message.count("no locks held") == 2


def test_primitives_survive_uninstrument():
    rt = dynrace.RaceRuntime({}, root=REPO)
    with dynrace.instrument(rt):
        lk, cv = threading.Lock(), threading.Condition()
    events = rt.events
    with lk:
        pass
    with cv:
        cv.notify_all()
    assert rt.events == events


# -- the seeded-bug fixtures, through both detectors -------------------------
def _wal_close_race(pkg):
    wal_mod = _load("wal_close_race")
    rt = pkg.RaceRuntime({wal_mod.RacyWriteAheadLog: frozenset({"_durable"})}, root=REPO)
    with pkg.instrument(rt):
        w = wal_mod.RacyWriteAheadLog()
        w.append({"op": "probe"})
        gate = {"parked": False, "go": False}

        def park():
            gate["parked"] = True
            _spin(gate, "go")

        w.before_publish = park
        closer = threading.Thread(target=w.close, name="closer")
        closer.start()
        _spin(gate, "parked")
        assert w.durable_seq == 0
        gate["go"] = True
        closer.join()
    return rt.findings()


def _motpe_inversion(pkg):
    mod = _load("motpe_inversion")
    rt = pkg.RaceRuntime({mod.MiniTPE: frozenset()}, root=REPO)
    with pkg.instrument(rt):
        m = mod.MiniMOTPE()
        m.suggest()
        m.state_dict()
    return rt.findings()


@pytest.mark.parametrize("scenario", [_wal_close_race, _motpe_inversion],
                         ids=["wal_close_race", "motpe_inversion"])
def test_fixture_findings_equal_the_reference(scenario):
    want = [(f.rule, f.file, f.line, f.symbol, f.detail) for f in scenario(ref_dynrace)]
    got = [(f.rule, f.file, f.line, f.symbol, f.detail) for f in scenario(dynrace)]
    assert got == want and got


def test_wal_close_race_rediscovered():
    races = [f for f in _wal_close_race(dynrace) if f.rule == "MTR101"]
    assert len(races) == 1
    f = races[0]
    assert (f.symbol, f.detail) == ("RacyWriteAheadLog._durable", "close|durable_seq")
    assert f.file == os.path.join("tests", "torch_fixtures", "race", "wal_close_race.py")
    assert "holding RacyWriteAheadLog._cv" in f.message and "no locks held" in f.message


def test_motpe_inversion_rediscovered():
    inv = {f.detail: f for f in _motpe_inversion(dynrace) if f.rule == "MTR102"}
    f = inv["MiniTPE._kernel_lock->MiniTPE._launch_lock"]
    assert "in state_dict" in f.message and "in suggest" in f.message


# -- locks the framework creates ----------------------------------------------
_INVERT = '''
import threading
a = threading.Lock()
b = threading.Lock()
def ab():
    with a:
        with b:
            pass
def ba():
    with b:
        with a:
            pass
'''


@pytest.mark.parametrize("where,cycles", [(("x", "torch", "_fake.py"), 0),
                                          (("x", "lib", "_fake.py"), 2)],
                         ids=["inside-torch", "elsewhere"])
def test_a_lock_torch_creates_never_enters_the_order_graph(where, cycles):
    ns = {}
    rt = dynrace.RaceRuntime({}, root=REPO)
    with dynrace.instrument(rt):
        exec(compile(_INVERT, os.sep + os.path.join(*where), "exec"), ns)
        ns["ab"]()
        ns["ba"]()
    assert len([f for f in rt.findings() if f.rule == "MTR102"]) == cycles


# -- the port's clean gate ----------------------------------------------------
def test_static_shared_attrs_clean():
    findings, stats = run_race([], static=True)
    assert not diff_baseline(findings, load_baseline(DEFAULT_RACE_BASELINE)), \
        "\n".join(f.render() for f in findings)
    assert stats["static_runtime_s"] >= 0.0


def test_race_suites_clean_on_the_cpu(capsys):
    assert race_main(["--suite", "all", "--format", "json"], device="cpu") == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["suites"] == ["coord", "algo", "wal", "sim"]
    assert doc["stats"]["events"] > 10_000


class _PingWhileListening:
    """``shards.log`` whose "router listening" line first pings the router:
    the first ping lands while ``ShardRouter.start`` is still running."""

    def __init__(self, real):
        self.real, self.replies = real, []

    def info(self, msg, *args):
        if msg.startswith("shard router listening"):
            from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg

            with socket.create_connection(args[:2], timeout=30) as c:
                send_msg(c, {"op": "ping", "args": {}})
                self.replies.append(recv_msg(c))
        self.real.info(msg, *args)

    def __getattr__(self, name):
        return getattr(self.real, name)


def _ping_during_router_start(scale, device):
    """A router over one stub shard that answers every ping with a newer
    map, so the first ping's connection thread writes ``_addrs`` in
    ``update_map`` while ``start`` has not returned."""
    from metaopt_tpu_torch.coord import shards
    from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg

    stub = socket.create_server(("127.0.0.1", 0))
    host, port = stub.getsockname()[:2]
    old = shards.make_shard_map([("s0", host, port)])
    new = dict(old, version=shards.map_version(old) + 1)

    def serve_stub():
        conn, _ = stub.accept()
        with conn:
            while recv_msg(conn) is not None:
                send_msg(conn, {"ok": True, "result": {"shard_map": new, "caps": []}})

    t = threading.Thread(target=serve_stub, daemon=True)
    t.start()
    spy = _PingWhileListening(shards.log)
    shards.log = spy
    try:
        router = shards.ShardRouter(old).start()
    finally:
        shards.log = spy.real
    try:
        with router._map_lock:
            return spy.replies, shards.map_version(router.shard_map)
    finally:
        router.stop()
        stub.close()
        t.join(timeout=10)


def test_a_ping_while_the_router_starts_races_nothing():
    findings, events, (replies, version) = run_race_leg(_ping_during_router_start, 1, "cpu")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert [r["result"]["shard_map"]["version"] for r in replies] == [version] and version > 1
    assert events > 0


def test_the_handoff_leg_is_clean_on_the_cpu():
    findings, events, _ = run_race_leg(suites._coord_handoff_phase, 1, "cpu")
    assert findings == [], "\n".join(f.render() for f in findings)
    assert events > 1000


@pytest.mark.slow
def test_race_suites_clean_chaos_length():
    assert race_main(["--suite", "all", "--scale", "5"], device="cpu") == 0


@pytest.mark.parametrize("leg", ["_coord_batched_phase", "_coord_fuser_phase"])
def test_the_device_legs_on_the_cpu(leg):
    findings, events, out = run_race_leg(getattr(suites, leg), 1, "cpu")
    assert findings == [] and events > 1000
    if leg == "_coord_batched_phase":
        assert out["rows_evaluated"] == 16 and out["pools"] >= 4
    else:
        assert out["launch_errors"] == 0 and out["ticks"] > 0


def test_the_race_cli_takes_the_coordinator_device(tmp_path, capsys):
    from metaopt_tpu_torch.cli import main

    cfg = tmp_path / "cpu.json"
    cfg.write_text(json.dumps({"coordinator": {"device": "cpu"}}))
    assert main(["race", "--suite", "sim", "--config", str(cfg)]) == 0
    assert "clean:" in capsys.readouterr().out
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["race", "--suite", "sim"])
