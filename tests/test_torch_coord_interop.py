"""The port's coordinator against the reference's, across packages.

- Each client drives the other package's server, on JSON and on the binary
  v2 wire: the whole op set and ``worker_cycle``, replies compared as
  documents with the reference client against the reference server.
- Hosted numpy algorithms (random search, ASHA) give the reference's
  ledger exactly: one worker, the same seed and objective, equal params,
  order and status.
- Each server recovers the other's state: a v1 or v2 snapshot (v2 with
  sealed-segment files) plus its WAL tail, read back with equal
  documents, counts and ``fetch_completed_since`` deltas.

The port's servers host on the CPU (``device="cpu"``); the reference runs
under ``JAX_PLATFORMS=cpu``.
"""

import json

import pytest

from metaopt_tpu.coord import CoordLedgerClient as RefClient
from metaopt_tpu.coord import CoordServer as RefServer
from metaopt_tpu.coord.protocol import HAVE_WIRE_V2
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu_torch.coord import CoordLedgerClient as PortClient
from metaopt_tpu_torch.coord import CoordServer as _PortServer
from metaopt_tpu_torch.ledger.trial import Trial as PortTrial

#: stamps that differ run to run, never part of the compared documents
_CLOCK_FIELDS = ("submit_time", "start_time", "end_time", "heartbeat")


def PortServer(*args, **kw):
    return _PortServer(*args, device="cpu", **kw)


SERVERS = {"port": PortServer, "ref": RefServer}
CLIENTS = {"port": (PortClient, PortTrial), "ref": (RefClient, RefTrial)}
WIRES = ["v1", pytest.param("auto", marks=pytest.mark.skipif(
    not HAVE_WIRE_V2, reason="msgpack unavailable: wire v2 off"))]


def _client(kind, server, wire="auto"):
    cls, _ = CLIENTS[kind]
    host, port = server.address
    return cls(host=host, port=port, wire=wire, reconnect_window_s=5.0,
               **({"io_timeout_s": 30.0} if kind == "port" else {}))


def _doc(x):
    """A reply as a plain document with the clock stamps dropped."""
    if hasattr(x, "to_dict"):
        x = x.to_dict()
    if isinstance(x, dict):
        return {k: _doc(v) for k, v in x.items() if k not in _CLOCK_FIELDS}
    if isinstance(x, (list, tuple)):
        return [_doc(v) for v in x]
    return x


SPACE = {"x": "uniform(-5, 5)", "y": "uniform(0, 1)"}


def _config(name, algo, space=SPACE, max_trials=6):
    from metaopt_tpu_torch.space import build_space

    return {"name": name, "space": build_space(space).configuration,
            "algorithm": algo, "max_trials": max_trials, "pool_size": 2,
            "metadata": {"user": "t"}, "version": 1, "refers": {}}


def _script(c, Trial, snap_path):
    """Every op of the client's surface, in one deterministic order;
    returns the replies."""
    out = []
    ping = c.ping()
    out.append(sorted(set(ping["caps"]) - {"wire_v2"}))
    out.append([ping["pong"], ping["durable"]])
    c.create_experiment(_config("e", {"random": {"seed": 4}}))
    try:
        c.create_experiment(_config("e", {"random": {"seed": 4}}))
    except Exception as err:  # duplicate: both packages raise it typed
        out.append(type(err).__name__)
    out.append(c.load_experiment("e"))
    c.update_experiment("e", {"metadata": {"user": "u"}})
    out.append(c.load_experiment("e")["metadata"])
    out.append(c.list_experiments())
    manual = Trial(params={"x": 0.5, "y": 0.25}, experiment="e")
    c.register(manual)
    try:
        c.register(manual)
    except Exception as err:
        out.append(type(err).__name__)
    out.append(c.produce("e", pool_size=2, worker="w0"))
    t = c.reserve("e", "w1")
    out.append(t)
    out.append([c.heartbeat("e", t.id, "w1"), c.heartbeat("e", t.id, "nobody")])
    out.append(c.get("e", t.id))
    out.append(c.fetch("e", ("new", "reserved")))
    out.append([c.count("e"), c.count("e", "new"), c.count("e", ("new", "reserved"))])
    out.append(c.judge("e", t, [{"objective": 1.0, "step": 1}]))
    out.append(c.should_suspend("e", t))
    c.set_signal("e", t.id, "stop")
    out.append(c.heartbeat("e", t.id, "w1"))
    t.transition("completed")
    t.attach_results([{"name": "objective", "type": "objective", "value": 2.5}])
    out.append(c.update_trial(t, expected_status="reserved", expected_worker="w1"))
    trials, _cursor = c.fetch_completed_since("e", None)
    out.append(trials)
    r = c.worker_cycle("e", "w2", pool_size=2, stale_timeout_s=60.0)
    while r["trial"] is not None:
        out.append({k: v for k, v in r.items() if k != "coalesced"})
        done = r["trial"]
        done.transition("completed")
        done.attach_results([{"name": "objective", "type": "objective",
                              "value": float(done.params["x"]) ** 2}])
        r = c.worker_cycle("e", "w2", pool_size=2, complete={
            "trial": done.to_dict(), "expected_status": "reserved",
            "expected_worker": "w2"})
    out.append({k: v for k, v in r.items() if k != "coalesced"})
    c.register(Trial(params={"x": 1.5, "y": 0.5}, experiment="e"))
    stale = c.reserve("e", "w3")
    out.append(c.release_stale("e", -1.0))
    out.append(c.get("e", stale.id).status)
    stats = c.tenant_stats(include_experiments=True)
    out.append({k: stats[k] for k in ("resident", "evicted", "evictions", "hydrations")})
    out.append(stats["experiments"])
    out.append(c.snapshot(snap_path) == snap_path)
    out.append(c.delete_experiment("e"))
    out.append([c.list_experiments(), c.load_experiment("e")])
    return _doc(out)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_each_client_drives_the_other_packages_server(tmp_path, client, server, wire):
    with RefServer() as base_srv:
        want = _script(_client("ref", base_srv, wire), RefTrial, str(tmp_path / "a.json"))
    with SERVERS[server]() as srv:
        c = _client(client, srv, wire)
        got = _script(c, CLIENTS[client][1], str(tmp_path / "b.json"))
        spoke = c._wire_for(c._seed)
    assert got == want
    assert spoke == ("v2" if wire == "auto" else "v1")


def _hosted_hunt(server_cls, algo, space, max_trials, objective):
    from metaopt_tpu_torch.executor import InProcessExecutor
    from metaopt_tpu_torch.ledger import Experiment
    from metaopt_tpu_torch.worker import workon

    with server_cls() as srv:
        c = _client("port", srv)
        cfg = _config("h", algo, space=space, max_trials=max_trials)
        c.create_experiment(cfg)
        exp = Experiment("h", c).configure()
        workon(exp, InProcessExecutor(objective), worker_id="w0",
               producer_mode="coord", max_idle_cycles=50, idle_sleep_s=0.0)
        return [(t.id, t.params, t.status, t.objective) for t in c.fetch("h")]


@pytest.mark.parametrize("algo,space,max_trials", [
    ({"random": {"seed": 13}}, SPACE, 16),
    ({"asha": {"seed": 5, "num_rungs": 3, "grace_period": 1, "reduction_factor": 2}},
     {"x": "uniform(0, 1)", "epochs": "fidelity(1, 4, base=2)"}, 20),
])
def test_hosted_numpy_algorithms_give_the_reference_ledger_exactly(algo, space, max_trials):
    def objective(p):
        return (p["x"] - 0.3) ** 2 * (1.0 + 1.0 / float(p.get("epochs", 1)))

    got = _hosted_hunt(PortServer, algo, space, max_trials, objective)
    want = _hosted_hunt(RefServer, algo, space, max_trials, objective)
    assert len(got) >= max_trials
    assert got == want


def _state_by(server_cls, c, snap, incremental, writer):
    """Build one server's state: a snapshot after 20 completions (sealed
    into 8-row archive segments), then a WAL tail (more completions, a
    reservation and a signal) that no snapshot reflects."""
    c.create_experiment(_config("r", {"random": {"seed": 1}}, max_trials=99))
    Trial = CLIENTS[writer][1]
    for i in range(30):
        c.register(Trial(params={"x": float(i) / 10.0 - 1.0, "y": 0.5}, experiment="r"))

    def complete(k):
        for _ in range(k):
            t = c.reserve("r", "w0")
            t.transition("completed")
            t.attach_results([{"name": "objective", "type": "objective",
                               "value": float(t.params["x"]) ** 2}])
            assert c.update_trial(t, expected_status="reserved")

    complete(20)
    c.snapshot(snap)
    complete(5)
    held = c.reserve("r", "w9")
    c.set_signal("r", held.id, "stop")
    return held.id


@pytest.mark.parametrize("incremental", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_server_recovers_the_others_snapshot_and_wal_tail(tmp_path, writer, reader,
                                                               incremental):
    snap = str(tmp_path / "snap.json")
    kw = dict(snapshot_path=snap, snapshot_incremental=incremental,
              archive_segment_rows=8)
    with SERVERS[writer](**kw) as s1:
        c1 = _client(writer, s1)
        held = _state_by(SERVERS[writer], c1, snap, incremental, writer)
        before = _doc(c1.fetch("r"))
        counts = {s: c1.count("r", s) for s in ("new", "reserved", "completed")}
        delta, cur = c1.fetch_completed_since("r", None)
        s1.snapshot_path = None  # kill -9: no shutdown snapshot
        s1.stop()
    state = json.load(open(snap))
    assert state["version"] == (2 if incremental else 1)
    if incremental:
        assert state["sections"]["r"]["segments"]  # sealed segment files
    with SERVERS[reader](**kw) as s2:
        c2 = _client(reader, s2)
        after = _doc(c2.fetch("r"))
        key = lambda d: d["id"]  # noqa: E731
        assert sorted(after, key=key) == sorted(before, key=key)
        assert {s: c2.count("r", s) for s in counts} == counts
        got, cur2 = c2.fetch_completed_since("r", None)
        assert sorted(_doc(got), key=key) == sorted(_doc(delta), key=key)
        assert c2.fetch_completed_since("r", cur2)[0] == []
        assert s2._signals.get(("r", held)) == "stop"


def _shard_pair(kind, tmp_path):
    """Two in-process shards of one package behind one map; returns the
    servers (started) and the map."""
    from metaopt_tpu_torch.coord.shards import _free_port, make_shard_map

    smap = make_shard_map([(f"s{i}", "127.0.0.1", _free_port())
                           for i in range(2)])
    servers = []
    for s in smap["shards"]:
        srv = SERVERS[kind](host=s["host"], port=s["port"], shard_id=s["id"],
                            shard_map=smap,
                            snapshot_path=str(tmp_path / f"{kind}-{s['id']}.snap"))
        servers.append(srv.start())
    return servers, smap


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_each_client_routes_over_the_other_packages_shards(tmp_path, client,
                                                           server, wire):
    """A client of one package, seeded at shard s0 of the other package,
    learns the shard map from that shard's ping and completes trials on
    both shards directly; each shard holds only the experiment it owns,
    and a map that the seed bumps (a rebalance's override) is adopted."""
    from metaopt_tpu_torch.coord.shards import ring_of, with_override

    servers, smap = _shard_pair(server, tmp_path)
    try:
        cls, Trial = CLIENTS[client]
        host, port = servers[0].address
        c = cls(host=host, port=port, wire=wire, reconnect_window_s=5.0,
                **({"io_timeout_s": 30.0} if client == "port" else {}))
        ping = c.ping()
        assert "shard_map" in ping["caps"] and ping["shard_map"] == smap
        assert c._ring is not None
        ring = ring_of(smap)
        names = {}
        for i in range(100):
            names.setdefault(ring.owner(f"ix-{i}"), f"ix-{i}")
        assert sorted(names) == ["s0", "s1"]
        for sid, nm in sorted(names.items()):
            c.create_experiment(_config(nm, {"random": {"seed": 3}}, max_trials=3))
            done = None
            for _ in range(3):
                r = c.worker_cycle(nm, "w0", pool_size=2, complete=done)
                t = r["trial"]
                t.transition("completed")
                t.attach_results([{"name": "objective", "type": "objective",
                                   "value": float(t.params["x"]) ** 2}])
                done = {"trial": t.to_dict(), "expected_status": "reserved",
                        "expected_worker": "w0"}
            r = c.worker_cycle(nm, "w0", pool_size=2, complete=done,
                               produce=False)
            assert r["completed_ok"]
            assert c.count(nm, "completed") == 3
        for srv, sid in zip(servers, ("s0", "s1")):
            assert srv.inner.list_experiments() == [names[sid]]
        assert sorted(c.list_experiments()) == [names["s0"]]  # seed's view
        # the seed adopts a bumped map; the client follows on its next ping
        moved = with_override(smap, names["s0"], "s1")
        for srv in servers:
            srv._handle({"op": "shard_map_update", "args": {"shard_map": moved}})
        c.ping()
        assert c._map_version == 2 and c._ring.owner(names["s0"]) == "s1"
        if wire == "auto":
            assert c._wire_for(c._seed) == "v2"
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("wire", ["v1", pytest.param("v2", marks=pytest.mark.skipif(
    not HAVE_WIRE_V2, reason="msgpack unavailable: wire v2 off"))])
@pytest.mark.parametrize("source,dest", [("ref", "port"), ("port", "ref")])
def test_an_experiment_migrates_between_the_packages_shards(tmp_path, monkeypatch, source,
                                                            dest, wire):
    """The hand-off admin plane speaks one protocol on either wire: the
    port's ``migrate_experiment`` moves an experiment from one package's
    shard to the other's (prepare, apply, commit), every acknowledged
    completion and cached reply arrives, and the source answers
    ``WrongShardError``."""
    from metaopt_tpu_torch.coord import handoff
    from metaopt_tpu_torch.coord.handoff import migrate_experiment
    from metaopt_tpu_torch.coord.shards import (_free_port, make_shard_map,
                                                ring_of, with_override)

    if wire == "v1":   # an orchestrator without msgpack ships the state as JSON
        monkeypatch.setattr(handoff, "HAVE_WIRE_V2", False)

    smap = make_shard_map([(f"s{i}", "127.0.0.1", _free_port()) for i in range(2)])
    kinds = {"s0": source, "s1": dest}
    servers = {s["id"]: SERVERS[kinds[s["id"]]](
        host=s["host"], port=s["port"], shard_id=s["id"], shard_map=smap,
        snapshot_path=str(tmp_path / f"{s['id']}.snap")).start()
        for s in smap["shards"]}
    try:
        nm = next(f"mv-{i}" for i in range(100) if ring_of(smap).owner(f"mv-{i}") == "s0")
        c = _client("port", servers["s0"])
        c.ping()
        c.create_experiment(_config(nm, {"random": {"seed": 9}}, max_trials=8))
        done = None
        for _ in range(4):
            t = c.worker_cycle(nm, "w0", pool_size=2, complete=done)["trial"]
            t.transition("completed")
            t.attach_results([{"name": "objective", "type": "objective",
                               "value": float(t.params["x"]) ** 2}])
            done = {"trial": t.to_dict(), "expected_status": "reserved",
                    "expected_worker": "w0"}
        c.worker_cycle(nm, "w0", pool_size=2, complete=done, produce=False)
        before = sorted(_doc(c.fetch(nm)), key=lambda d: d["id"])
        new_map = with_override(smap, nm, "s1")
        res = migrate_experiment(nm, servers["s0"].address, servers["s1"].address,
                                 "s1", new_map, window_s=10.0)
        assert {handoff._ADDR_WIRE[servers[sid].address] for sid in kinds} == {wire}
        assert res["trials"] == len(before) and res["replies"] >= 5
        assert res["map_version"] == 2
        c.ping()
        assert c._ring.owner(nm) == "s1"
        assert sorted(_doc(c.fetch(nm)), key=lambda d: d["id"]) == before
        assert c.count(nm, "completed") == 4
        miss = servers["s0"]._handle({"op": "count", "args": {"experiment": nm}})
        assert miss["error"] == "WrongShardError"
        assert nm not in servers["s0"].inner.list_experiments()
    finally:
        for srv in servers.values():
            srv.stop()
