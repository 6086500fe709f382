"""Live shard hand-off in the port: migration, fences, map monotonicity,
the WAL tail, offline recovery and failover.

The cases restate ``tests/unit/test_coord_handoff.py`` against
``metaopt_tpu_torch.coord``: a live experiment moves between running
shards with ZERO acked-write loss, an exactly-once retry that straddles
the move is answered from the SHIPPED reply cache, and routing converges
on the version-bumped map without ever rolling back. One kill -9 barrier
of ``tests/functional/test_coord_handoff_chaos.py`` (the source shard
dies after its fence, before its capture) runs here unmarked.

Cross-package, exactly: ``with_override`` / ``without_shard`` give the
reference's maps over 1,000 names, ``extract_tail`` returns the
reference's records from one WAL file, and ``recover_shard_state`` reads
a shard directory that the reference's server wrote (snapshot v1 and v2
with sealed segments, plus the WAL tail) into the reference's state.

Shards host on the CPU (``device="cpu"``); clients carry an
``io_timeout_s`` and every wait a deadline, so a hang fails the case.
"""

import json
import os
import socket
import threading
import time
import uuid

import pytest

from metaopt_tpu.coord import CoordServer as RefServer
from metaopt_tpu.coord.handoff import recover_shard_state as ref_recover
from metaopt_tpu.coord.shards import with_override as ref_with_override
from metaopt_tpu.coord.shards import without_shard as ref_without_shard
from metaopt_tpu.coord.wal import WriteAheadLog as RefWAL
from metaopt_tpu_torch.coord import CoordLedgerClient, ShardSupervisor
from metaopt_tpu_torch.coord.handoff import recover_shard_state
from metaopt_tpu_torch.coord.protocol import recv_msg, send_msg
from metaopt_tpu_torch.coord.shards import (
    RoutingTable,
    make_shard_map,
    map_version,
    ring_of,
    with_override,
    without_shard,
)
from metaopt_tpu_torch.coord.wal import WriteAheadLog, record_experiment
from metaopt_tpu_torch.ledger import Experiment
from metaopt_tpu_torch.space import build_space


def _client(host, port, window=30.0):
    return CoordLedgerClient(host=host, port=port,
                             reconnect_window_s=window, io_timeout_s=60.0)


def _configure(client, name, budget=6, seed=5):
    Experiment(
        name, client, space=build_space({"x": "uniform(-1, 1)"}),
        max_trials=budget, pool_size=3,
        algorithm={"random": {"seed": seed}},
    ).configure()


def _drain(client, name, budget, worker="w0"):
    complete = None
    for _ in range(budget * 6):
        out = client.worker_cycle(name, worker, pool_size=3,
                                  complete=complete)
        complete = None
        t = out["trial"]
        if t is None:
            if out["counts"]["completed"] >= budget:
                return
            continue
        t.attach_results([{"name": "objective", "type": "objective",
                           "value": t.params["x"] ** 2}])
        t.transition("completed")
        complete = {"trial": t.to_dict(), "expected_status": "reserved",
                    "expected_worker": worker}
    raise AssertionError(f"{name}: budget {budget} not drained")


def _raw_call(addr, msg):
    with socket.create_connection(addr, timeout=30) as s:
        send_msg(s, msg)
        return recv_msg(s)


def _split_names(shard_map, prefix):
    """(name owned by shard 0's id, its sid, the other sid)."""
    ring = ring_of(shard_map)
    sids = [s["id"] for s in shard_map["shards"]]
    i = 0
    while True:
        nm = f"{prefix}-{i}"
        if ring.owner(nm) == sids[0]:
            return nm, sids[0], sids[1]
        i += 1


def _exp_owned_by(sid, prefix):
    ring = ring_of(make_shard_map([("s0", "127.0.0.1", 1),
                                   ("s1", "127.0.0.1", 2)]))
    return next(f"{prefix}-{i}" for i in range(10_000)
                if ring.owner(f"{prefix}-{i}") == sid)


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def sup(tmp_path_factory):
    """One two-shard deployment for the live-migration cases; each case
    moves an experiment of its own."""
    snap = str(tmp_path_factory.mktemp("handoff-shards"))
    with ShardSupervisor(2, snapshot_dir=snap, restart=False,
                         device="cpu") as s:
        yield s


def _src_dest(sup, nm):
    table = RoutingTable(sup.shard_map)
    src = table.owner(nm)
    dest = [s["id"] for s in sup.shard_map["shards"] if s["id"] != src][0]
    return table, src, dest


class TestMapHelpers:
    def test_with_override_bumps_version_and_pins(self):
        m = make_shard_map([("s0", "h", 1), ("s1", "h", 2)])
        nm, src, dest = _split_names(m, "ov")
        m2 = with_override(m, nm, dest)
        assert map_version(m2) == map_version(m) + 1
        assert RoutingTable(m2).owner(nm) == dest
        # the input map is untouched (deep copy)
        assert "overrides" not in m or not m.get("overrides")
        assert RoutingTable(m).owner(nm) == src

    def test_with_override_unpins_natural_owner(self):
        m = make_shard_map([("s0", "h", 1), ("s1", "h", 2)])
        nm, src, dest = _split_names(m, "nat")
        m3 = with_override(with_override(m, nm, dest), nm, src)
        assert m3["overrides"] == {}
        assert RoutingTable(m3).owner(nm) == src

    def test_with_override_rejects_unknown_dest(self):
        m = make_shard_map([("s0", "h", 1)])
        with pytest.raises(ValueError):
            with_override(m, "e", "s9")

    def test_without_shard_drops_dead_overrides_only(self):
        m = make_shard_map([("s0", "h", 1), ("s1", "h", 2),
                            ("s2", "h", 3)])
        ring = ring_of(m)
        pin_dead = next(f"pd-{i}" for i in range(999)
                        if ring.owner(f"pd-{i}") != "s0")
        pin_live = next(f"pl-{i}" for i in range(999)
                        if ring.owner(f"pl-{i}") not in ("s0", "s1"))
        m = with_override(m, pin_dead, "s0")
        m = with_override(m, pin_live, "s1")
        m2 = without_shard(m, "s0")
        assert [s["id"] for s in m2["shards"]] == ["s1", "s2"]
        assert pin_dead not in m2["overrides"]
        assert m2["overrides"].get(pin_live) == "s1"
        assert map_version(m2) == map_version(m) + 1
        with pytest.raises(ValueError):
            without_shard(without_shard(m2, "s1"), "s2")

    def test_routing_table_owner_matches_ring_without_overrides(self):
        m = make_shard_map([("s0", "h", 1), ("s1", "h", 2)])
        ring, table = ring_of(m), RoutingTable(m)
        for i in range(100):
            assert table.owner(f"e{i}") == ring.owner(f"e{i}")

    def test_map_helpers_equal_reference_over_1000_names(self):
        m = make_shard_map([(f"s{i}", "127.0.0.1", 7000 + i)
                            for i in range(4)])
        port_map = ref_map = m
        for i in range(1000):
            nm, dest = f"exp-{i}", f"s{(i * 7) % 4}"
            port_map = with_override(port_map, nm, dest)
            ref_map = ref_with_override(ref_map, nm, dest)
        assert port_map == ref_map
        assert map_version(port_map) == 1001
        for dead in ("s2", "s0"):
            port_map = without_shard(port_map, dead)
            ref_map = ref_without_shard(ref_map, dead)
            assert port_map == ref_map
        names = [f"exp-{i}" for i in range(1000)]
        table = RoutingTable(port_map)
        assert {table.owner(n) for n in names} <= {"s1", "s3"}


class TestLiveMigration:
    def test_migration_preserves_acked_trials(self, sup):
        host, port = sup.address
        c = _client(host, port)
        c.ping()
        nm = "mig-a"
        _, src, dest = _src_dest(sup, nm)
        _configure(c, nm)
        _drain(c, nm, 3)
        ids_before = {t.id for t in c.fetch(nm)}
        completed_before = c.count(nm, "completed")
        assert completed_before >= 3
        res = sup.handoff(nm, dest)
        assert res is not None and res["trials"] == len(ids_before)
        # the same call again is a no-op (already there)
        assert sup.handoff(nm, dest) is None
        assert RoutingTable(sup.shard_map).owner(nm) == dest
        after = [t.id for t in c.fetch(nm)]
        assert sorted(after) == sorted(ids_before)
        assert c.count(nm, "completed") == completed_before
        _drain(c, nm, 6)
        assert c.count(nm, "completed") == 6

    def test_exactly_once_retry_spans_migration(self, sup):
        # a fused worker_cycle answered by the SOURCE, retried (same
        # request id) against the DESTINATION after the move, gets the
        # cached reply back — the reply cache ships with the experiment
        host, port = sup.address
        c = _client(host, port)
        c.ping()
        nm = "mig-b"
        table, src, dest = _src_dest(sup, nm)
        _configure(c, nm)
        addrs = table.addrs
        msg = {"op": "worker_cycle", "req": uuid.uuid4().hex,
               "args": {"experiment": nm, "worker": "w-retry",
                        "pool_size": 3, "produce": True,
                        "complete": None}}
        first = _raw_call(addrs[src], msg)
        assert first["ok"] and first["result"]["trial"] is not None
        sup.handoff(nm, dest)
        second = _raw_call(addrs[dest], msg)
        assert second["ok"], second
        assert second["result"] == first["result"]
        assert c.count(nm, "reserved") == 1

    def test_source_answers_wrong_shard_after_commit(self, sup):
        host, port = sup.address
        c = _client(host, port)
        c.ping()
        nm = "mig-c"
        table, src, dest = _src_dest(sup, nm)
        _configure(c, nm)
        sup.handoff(nm, dest)
        r = _raw_call(table.addrs[src],
                      {"op": "load_experiment", "req": uuid.uuid4().hex,
                       "args": {"name": nm}})
        assert not r["ok"] and r["error"] == "WrongShardError"

    def test_migration_under_concurrent_writes(self, sup):
        # workers hammer the experiment THROUGH the migration; the fence
        # answers Migrating (retryable) and every acknowledged completion
        # exists afterwards
        host, port = sup.address
        nm = "mig-d"
        _, src, dest = _src_dest(sup, nm)
        boot = _client(host, port)
        _configure(boot, nm, budget=40)
        acked = []
        stop = threading.Event()
        fails = []

        def work(wid):
            cl = _client(host, port)
            complete = None
            try:
                while not stop.is_set():
                    out = cl.worker_cycle(nm, wid, pool_size=4,
                                          complete=complete)
                    if complete is not None and out.get("completed_ok"):
                        acked.append(complete["trial"]["id"])
                    complete = None
                    t = out["trial"]
                    if t is None:
                        time.sleep(0.01)
                        continue
                    t.attach_results([
                        {"name": "objective", "type": "objective",
                         "value": t.params["x"] ** 2}])
                    t.transition("completed")
                    complete = {"trial": t.to_dict(),
                                "expected_status": "reserved",
                                "expected_worker": wid}
            except Exception as e:  # surfaced below
                fails.append(e)

        threads = [threading.Thread(target=work, args=(f"w{i}",),
                                    daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        sup.handoff(nm, dest)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
        assert not fails, fails
        assert acked, "no completion was acknowledged"
        final = {t.id for t in boot.fetch(nm)}
        lost = set(acked) - final
        assert not lost, f"acked completions lost in the move: {lost}"
        assert RoutingTable(sup.shard_map).owner(nm) == dest


class TestClientMapMonotonicity:
    def test_stale_lower_version_map_never_rolls_back(self):
        old = make_shard_map([("s0", "h", 1), ("s1", "h", 2)])
        nm, src, dest = _split_names(old, "mono")
        new = with_override(old, nm, dest)
        c = CoordLedgerClient(host="127.0.0.1", port=9)
        c._caps = ("shard_map",)
        c._absorb_ping(c._seed, {"caps": ["shard_map"], "shard_map": new})
        assert c._ring.owner(nm) == dest
        assert c._map_version == map_version(new)
        c._absorb_ping(c._seed, {"caps": ["shard_map"], "shard_map": old})
        assert c._ring.owner(nm) == dest, "routing rolled back"
        assert c._map_version == map_version(new)
        newer = with_override(new, nm, src)
        c._absorb_ping(c._seed, {"caps": ["shard_map"],
                                 "shard_map": newer})
        assert c._map_version == map_version(newer)

    def test_cap_withdrawal_still_degrades(self):
        m = make_shard_map([("s0", "h", 1)])
        c = CoordLedgerClient(host="127.0.0.1", port=9)
        c._caps = ("shard_map",)
        c._absorb_ping(c._seed, {"caps": ["shard_map"], "shard_map": m})
        assert c._ring is not None
        c._absorb_ping(c._seed, {"caps": []})
        assert c._ring is None and c._map_version == -1


class TestWalHandoffSupport:
    def test_record_experiment_attribution(self):
        assert record_experiment(
            {"op": "put_trial", "trial": {"experiment": "e1"}}) == "e1"
        assert record_experiment(
            {"op": "create_experiment", "config": {"name": "e2"}}) == "e2"
        assert record_experiment(
            {"op": "update_experiment", "name": "e3"}) == "e3"
        assert record_experiment(
            {"op": "set_signal", "experiment": "e4"}) == "e4"
        assert record_experiment(
            {"op": "reply", "req": "r", "exp": "e5"}) == "e5"
        assert record_experiment({"op": "shard_map", "map": {}}) is None
        assert record_experiment(
            {"op": "handoff_fence", "experiment": "e6"}) is None

    def test_extract_tail_filters_by_experiment(self, tmp_path):
        path = str(tmp_path / "t.wal")
        wal = WriteAheadLog(path, fsync=False).open()
        try:
            wal.append({"op": "put_trial",
                        "trial": {"id": "a", "experiment": "keep"}})
            wal.append({"op": "put_trial",
                        "trial": {"id": "b", "experiment": "other"}})
            wal.append({"op": "set_signal", "experiment": "keep",
                        "trial_id": "a", "signal": "stop"})
            tail = wal.extract_tail("keep")
        finally:
            wal.close()
        assert [r["op"] for r in tail] == ["put_trial", "set_signal"]
        assert all(record_experiment(r) == "keep" for r in tail)

    def test_compaction_fenced_during_tail_extraction(self, tmp_path):
        path = str(tmp_path / "f.wal")
        wal = WriteAheadLog(path, fsync=False).open()
        try:
            for i in range(5):
                wal.append({"op": "put_trial",
                            "trial": {"id": f"t{i}", "experiment": "e"}})
            wal.sync(wal.appended_seq)
            started = threading.Event()
            done = threading.Event()

            def compact_racer():
                started.set()
                wal.compact(2)
                done.set()

            with wal.compaction_fence():
                t = threading.Thread(target=compact_racer, daemon=True)
                t.start()
                started.wait(5)
                assert not done.wait(0.3), \
                    "compact() ran inside a compaction fence"
                assert len(wal.extract_tail("e")) == 5
            assert done.wait(5), "compact() never resumed after the fence"
            t.join(timeout=5)
            assert len(wal.extract_tail("e")) == 3
        finally:
            wal.close()

    @pytest.mark.parametrize("writer", ["ref", "port"])
    def test_extract_tail_equals_reference_on_one_file(self, tmp_path,
                                                       writer):
        path = str(tmp_path / "x.wal")
        wal = (RefWAL if writer == "ref" else WriteAheadLog)(
            path, fsync=False).open()
        try:
            for i in range(40):
                exp = ("keep", "other", "third")[i % 3]
                wal.append({"op": "put_trial", "trial": {
                    "id": f"t{i}", "experiment": exp, "params": {"x": i},
                    "status": "completed", "objective": i * 0.5}})
                if i % 5 == 0:
                    wal.append({"op": "reply", "req": f"r{i}", "exp": exp,
                                "reply": {"ok": True, "result": i}})
            wal.append({"op": "shard_map", "map": {"version": 3}})
            wal.append({"op": "handoff_fence", "experiment": "keep",
                        "dest": "s1"})
            wal.append({"op": "set_signal", "experiment": "keep",
                        "trial_id": "t0", "signal": "stop"})
            wal.sync(wal.appended_seq)
        finally:
            wal.close()
        tails = {}
        for kind, cls in (("port", WriteAheadLog), ("ref", RefWAL)):
            w = cls(path, fsync=False).open()
            try:
                tails[kind] = {e: w.extract_tail(e)
                               for e in ("keep", "other", "absent")}
            finally:
                w.close()
        assert tails["port"] == tails["ref"]
        assert len(tails["port"]["keep"]) == 14 + 3 + 1
        assert tails["port"]["absent"] == []


class TestOfflineRecovery:
    def test_recover_from_wal_only(self, tmp_path):
        wal_path = str(tmp_path / "dead.wal")
        wal = WriteAheadLog(wal_path, fsync=False).open()
        try:
            wal.append({"op": "create_experiment",
                        "config": {"name": "exp-a", "max_trials": 5}})
            wal.append({"op": "put_trial",
                        "trial": {"id": "t1", "experiment": "exp-a",
                                  "status": "completed"}})
            wal.append({"op": "put_trial",
                        "trial": {"id": "t1", "experiment": "exp-a",
                                  "status": "completed",
                                  "objective": 1.0}})  # upsert wins
            wal.append({"op": "set_signal", "experiment": "exp-a",
                        "trial_id": "t1", "signal": "stop"})
            wal.append({"op": "reply", "req": "r1", "exp": "exp-a",
                        "reply": {"ok": True, "result": 1}})
            wal.append({"op": "create_experiment",
                        "config": {"name": "exp-b"}})
            wal.append({"op": "delete_experiment", "name": "exp-b"})
            wal.sync(wal.appended_seq)
        finally:
            wal.close()
        state = recover_shard_state(None, wal_path)
        assert set(state) == {"exp-a"}
        s = state["exp-a"]
        assert [t["id"] for t in s["trials"]] == ["t1"]
        assert s["trials"][0]["objective"] == 1.0
        assert s["signals"] == [{"trial_id": "t1", "signal": "stop"}]
        assert s["replies"] == [
            {"req": "r1", "reply": {"ok": True, "result": 1}}]

    def test_recover_missing_files_is_empty(self, tmp_path):
        assert recover_shard_state(str(tmp_path / "no.snap"),
                                   str(tmp_path / "no.wal")) == {}

    def test_prebound_reply_window_installs_cache_entry_only(self, tmp_path):
        """A crash between a snapshot publish and its compaction leaves
        acked reply records at or below the snapshot's WAL bound: their
        cache entries are installed, their embedded docs are not."""
        wal_path = str(tmp_path / "shard.wal")
        wal = WriteAheadLog(wal_path, fsync=False).open()
        try:
            wal.append({"op": "reply", "req": "r-res", "exp": "exp-a",
                        "reply": {"ok": True, "result": {
                            "id": "t1", "experiment": "exp-a",
                            "params": {"x": 1}, "status": "reserved"}}})
            wal.append({"op": "put_trial",
                        "trial": {"id": "t1", "experiment": "exp-a",
                                  "status": "reserved",
                                  "params": {"x": 1}}})
            wal.sync(wal.appended_seq)
        finally:
            wal.close()
        snap_path = str(tmp_path / "shard.snap")
        with open(snap_path, "w") as f:
            json.dump({"wal_seq": 10,
                       "experiments": {"exp-a": {"name": "exp-a"}},
                       "trials": {"exp-a": [
                           {"id": "t1", "experiment": "exp-a",
                            "status": "completed", "objective": 2.0,
                            "params": {"x": 1}}]},
                       "signals": []}, f)
        s = recover_shard_state(snap_path, wal_path)["exp-a"]
        assert s["replies"] == [
            {"req": "r-res", "reply": {"ok": True, "result": {
                "id": "t1", "experiment": "exp-a",
                "params": {"x": 1}, "status": "reserved"}}}]
        assert [t["status"] for t in s["trials"]] == ["completed"]
        assert s["trials"][0]["objective"] == 2.0

    def test_recover_inflates_v2_manifest_readonly(self, tmp_path):
        snap_path = str(tmp_path / "shard.snap")
        seg_dir = snap_path + ".segments"
        os.makedirs(seg_dir)
        with open(os.path.join(seg_dir, "seg-0.json"), "w") as f:
            json.dump({"docs": [
                {"id": "t1", "experiment": "exp-v", "status": "completed"},
                {"id": "t2", "experiment": "exp-v", "status": "completed"},
            ]}, f)
        with open(snap_path, "w") as f:
            json.dump({"version": 2, "wal_seq": 3, "sections": {
                "exp-v": {"experiment": {"name": "exp-v"},
                          "docs": [{"id": "t3", "experiment": "exp-v",
                                    "status": "reserved"}],
                          "segments": [{"file": "seg-0.json",
                                        "dead": [1]}]}},
                "signals": []}, f)
        before = os.path.getsize(snap_path)
        state = recover_shard_state(snap_path, None)
        assert {t["id"] for t in state["exp-v"]["trials"]} == {"t1", "t3"}
        assert os.path.getsize(snap_path) == before  # post-mortem = read

    def test_recover_merges_evicted_stub_from_evict_file(self, tmp_path):
        evict_path = str(tmp_path / "exp-e.evict")
        with open(evict_path, "w") as f:
            json.dump({"experiment": {"name": "exp-e"},
                       "trials": [{"id": "e1", "experiment": "exp-e",
                                   "status": "completed"}],
                       "signals": [{"trial_id": "e1", "signal": "stop"}],
                       "replies": [{"req": "r-e",
                                    "reply": {"ok": True}}]}, f)
        snap_path = str(tmp_path / "shard.snap")
        with open(snap_path, "w") as f:
            json.dump({"wal_seq": 1, "experiments": {},
                       "evicted": {"exp-e": {"path": evict_path}}}, f)
        s = recover_shard_state(snap_path, None)["exp-e"]
        assert [t["id"] for t in s["trials"]] == ["e1"]
        assert s["signals"] == [{"trial_id": "e1", "signal": "stop"}]
        assert s["replies"] == [{"req": "r-e", "reply": {"ok": True}}]

    def test_recover_replays_evict_record_then_overrides(self, tmp_path):
        evict_path = str(tmp_path / "exp-w.evict")
        with open(evict_path, "w") as f:
            json.dump({"experiment": {"name": "exp-w"},
                       "trials": [{"id": "w1", "experiment": "exp-w",
                                   "status": "reserved"}],
                       "signals": [], "replies": []}, f)
        wal_path = str(tmp_path / "shard.wal")
        wal = WriteAheadLog(wal_path, fsync=False).open()
        try:
            wal.append({"op": "evict", "experiment": "exp-w",
                        "path": evict_path})
            wal.append({"op": "put_trial",
                        "trial": {"id": "w1", "experiment": "exp-w",
                                  "status": "completed"}})
            wal.sync(wal.appended_seq)
        finally:
            wal.close()
        state = recover_shard_state(None, wal_path)
        assert state["exp-w"]["trials"][0]["status"] == "completed"

    @pytest.mark.parametrize("incremental", [False, True],
                             ids=["snapshot-v1", "snapshot-v2"])
    def test_recover_reads_a_reference_shard_like_the_reference(
            self, tmp_path, incremental):
        """A shard directory the REFERENCE's server wrote — snapshot (v1,
        or v2 with sealed segment files), then a WAL tail of completions,
        a signal, a delete and journaled replies — recovers into the
        reference's state dicts exactly, and the files stay untouched."""
        smap = make_shard_map([("s0", "127.0.0.1", 1),
                               ("s1", "127.0.0.1", 2)])
        names = [n for n in (f"rec-{i}" for i in range(40))
                 if ring_of(smap).owner(n) == "s0"][:3]
        snap = str(tmp_path / "shard-0.snap.json")
        srv = RefServer(snapshot_path=snap, snapshot_interval_s=3600.0,
                        snapshot_incremental=incremental,
                        archive_segment_rows=4, shard_id="s0",
                        shard_map=smap, wal_fsync=False, wal_group_ms=0.0)
        srv._recover()

        def call(op, **args):
            r = srv._handle({"op": op, "args": args,
                             "req": uuid.uuid4().hex})
            assert r["ok"], r
            srv._wal.sync(srv._barrier_seq(op))
            return r["result"]

        def cycle(nm, n):
            done = None
            for _ in range(n):
                out = call("worker_cycle", experiment=nm, worker="w",
                           pool_size=2, produce=True, complete=done)
                t = out["trial"]
                t["results"] = [{"name": "objective", "type": "objective",
                                 "value": t["params"]["x"] ** 2}]
                t["status"] = "completed"
                done = {"trial": t, "expected_status": "reserved",
                        "expected_worker": "w"}
            call("worker_cycle", experiment=nm, worker="w", pool_size=2,
                 produce=False, complete=done)

        for nm in names:
            call("create_experiment", config={
                "name": nm, "space": {"x": "uniform(-1, 1)"},
                "algorithm": {"random": {"seed": 3}}, "max_trials": 30,
                "pool_size": 2, "metadata": {}, "user_args": [],
                "version": 1})
            cycle(nm, 9)
        srv.snapshot(snap)
        cycle(names[0], 3)
        call("set_signal", experiment=names[1], trial_id="t-x",
             signal="stop")
        call("delete_experiment", name=names[2])
        # abandon the shard as a kill -9 would: no stop(), no snapshot
        srv._wal._f.close()
        files = sorted(os.listdir(tmp_path))
        sizes = {f: os.path.getsize(tmp_path / f) for f in files
                 if os.path.isfile(tmp_path / f)}
        ours = recover_shard_state(snap, snap + ".wal")
        theirs = ref_recover(snap, snap + ".wal")
        assert ours == theirs
        assert set(ours) == set(names[:2])
        assert len(ours[names[0]]["trials"]) >= 12
        assert ours[names[0]]["replies"]
        assert ours[names[1]]["signals"] == [
            {"trial_id": "t-x", "signal": "stop"}]
        if incremental:
            assert os.path.isdir(snap + ".segments")
        assert sizes == {f: os.path.getsize(tmp_path / f) for f in sizes}


class TestFailover:
    def test_failover_redistributes_dead_shard(self, tmp_path):
        with ShardSupervisor(2, snapshot_dir=str(tmp_path), failover=True,
                             device="cpu") as sup:
            host, port = sup.address
            c = _client(host, port)
            c.ping()
            table = RoutingTable(sup.shard_map)
            names = {}
            i = 0
            while len(names) < 2:
                nm = f"fo-{i}"
                names.setdefault(table.owner(nm), nm)
                i += 1
            completed = {}
            for nm in names.values():
                _configure(c, nm)
                _drain(c, nm, 3)
                completed[nm] = c.count(nm, "completed")
                assert completed[nm] >= 3
            sup.kill_shard(0)
            _wait_for(lambda: sup.failover_times, 30, "the failover")
            assert all(s["id"] != "s0" for s in sup.shard_map["shards"])
            for nm in names.values():
                assert c.count(nm, "completed") == completed[nm], nm
            # no respawn happened: failover replaces restart
            assert sup.crashes() == 1

    def test_failover_requires_snapshot_dir(self):
        with pytest.raises(ValueError):
            ShardSupervisor(2, failover=True, device="cpu")


def test_kill9_source_before_capture_loses_no_acked_write(tmp_path):
    """``crash_handoff_source`` at skip 0: the source dies fenced and
    drained, before its capture. The watcher respawns it disarmed, the
    orchestrator's retry window re-runs the prepare, and every completion
    acknowledged before or during the move survives it; the budget drains
    on the destination with no duplicate registration."""
    budget, workers = 24, 3
    nm = _exp_owned_by("s0", "chaos-handoff")
    env = {0: {"METAOPT_TPU_FAULTS": "crash_handoff_source:1@0"}}
    with ShardSupervisor(2, snapshot_dir=str(tmp_path),
                         snapshot_interval_s=0.5, restart=True,
                         shard_env=env, fuse_suggest=True,
                         device="cpu") as sup:
        host, port = sup.address
        client = _client(host, port)
        client.ping()
        _configure(client, nm, budget=budget, seed=13)
        lock = threading.Lock()
        acked = [0]
        errors = []

        def worker(w):
            c = _client(host, port)
            complete = None
            deadline = time.monotonic() + 120.0
            try:
                while time.monotonic() < deadline:
                    out = c.worker_cycle(nm, w, pool_size=workers,
                                         complete=complete)
                    if complete is not None:
                        with lock:
                            acked[0] += 1
                    complete = None
                    t = out["trial"]
                    if t is None:
                        if out["counts"]["completed"] >= budget:
                            return
                        time.sleep(0.005)
                        continue
                    t.attach_results([{"name": "objective",
                                       "type": "objective",
                                       "value": t.params["x"] ** 2}])
                    t.transition("completed")
                    complete = {"trial": t.to_dict(),
                                "expected_status": "reserved",
                                "expected_worker": w}
                raise AssertionError(f"{nm}: budget not drained")
            except BaseException as e:  # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(f"w{j}",))
                   for j in range(workers)]
        for t in threads:
            t.start()
        _wait_for(lambda: acked[0] >= 5, 30, "acked load before the move")
        with lock:
            acked_before = acked[0]
        sup.handoff(nm, "s1", drain_timeout_s=15.0, window_s=60.0)
        assert sup.crashes() == 1, "the armed fault never fired"
        assert RoutingTable(sup.shard_map).owner(nm) == "s1"
        assert client.count(nm, "completed") >= acked_before
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "workers wedged"
        if errors:
            raise errors[0]
        ids = [t.id for t in client.fetch(nm)]
        assert len(ids) == len(set(ids)) == budget
        assert client.count(nm, "completed") == budget >= acked[0]
