"""Sharded serving in the port: hash ring, routing, rolling upgrade, the
supervisor and the router.

The cases restate ``tests/unit/test_coord_shards.py`` against
``metaopt_tpu_torch.coord``: experiments are partitioned across N
subprocess CoordServer shards by a consistent-hash ring over experiment
ids; new clients learn the shard map from ping caps and route directly;
old clients (no ``shard_map`` cap) fall through the router, which relays
raw frames. Cross-package: the ring places 1,000 names where the
reference's does.

The shards host on the CPU (``device="cpu"``): without it they resolve
``cuda`` and the supervisor's start raises on a machine without CUDA,
which the device-rule cases check. One two-shard supervisor serves the
routing cases (each on names of its own), so the file pays for two shard
starts, not one per case.
"""

import json
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from metaopt_tpu.coord.shards import HashRing as RefHashRing
from metaopt_tpu.coord.shards import make_shard_map as ref_make_shard_map
from metaopt_tpu.coord.shards import ring_of as ref_ring_of
from metaopt_tpu_torch.coord import (CoordLedgerClient, CoordServer,
                                     ShardSupervisor)
from metaopt_tpu_torch.coord.shards import (
    HashRing,
    _free_port,
    experiment_of,
    make_shard_map,
    ring_of,
    stable_hash,
)
from metaopt_tpu_torch.ledger import Experiment, Trial
from metaopt_tpu_torch.space import build_space

REPO = Path(__file__).resolve().parents[1]
#: every client gets a per-recv timeout: a hung shard fails the case
IO_TIMEOUT_S = 60.0


def _client(host, port):
    return CoordLedgerClient(host=host, port=port, reconnect_window_s=30.0,
                             io_timeout_s=IO_TIMEOUT_S)


def _two_exp_names(shard_map, prefix="sh"):
    """One experiment name per shard, so a test exercises both."""
    ring = ring_of(shard_map)
    names = {}
    i = 0
    while len(names) < len(shard_map["shards"]):
        nm = f"{prefix}-{i}"
        names.setdefault(ring.owner(nm), nm)
        i += 1
    return names


def _drain(client, name, budget, worker="w0", pool_size=4):
    """Complete ``budget`` trials on ``name`` via the fused cycle."""
    complete = None
    for _ in range(budget * 6):
        out = client.worker_cycle(name, worker, pool_size=pool_size,
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


def _configure(client, name, budget):
    Experiment(
        name, client, space=build_space({"x": "uniform(-1, 1)"}),
        max_trials=budget, pool_size=budget,
        algorithm={"random": {"seed": 5}},
    ).configure()


@pytest.fixture(scope="module")
def sup():
    with ShardSupervisor(2, restart=False, device="cpu",
                         ready_timeout_s=120.0) as s:
        yield s


class TestHashRing:
    def test_owner_deterministic_across_instances(self):
        assert stable_hash("exp-a") == stable_hash("exp-a")
        r1 = HashRing(["s0", "s1", "s2"])
        r2 = HashRing(["s0", "s1", "s2"])
        for i in range(200):
            assert r1.owner(f"e{i}") == r2.owner(f"e{i}")

    def test_owner_independent_of_declaration_order(self):
        a = HashRing(["s0", "s1", "s2"])
        b = HashRing(["s2", "s0", "s1"])
        for i in range(200):
            assert a.owner(f"e{i}") == b.owner(f"e{i}")

    def test_balance_within_vnode_tolerance(self):
        ring = HashRing(["s0", "s1", "s2", "s3"])
        per: dict = {}
        n = 4000
        for i in range(n):
            sid = ring.owner(f"exp-{i}")
            per[sid] = per.get(sid, 0) + 1
        assert set(per) == {"s0", "s1", "s2", "s3"}
        for sid, cnt in per.items():
            assert n / 8 < cnt < n / 2, (sid, per)

    def test_minimal_movement_on_shard_add(self):
        before = HashRing(["s0", "s1", "s2"])
        after = HashRing(["s0", "s1", "s2", "s3"])
        keys = [f"exp-{i}" for i in range(2000)]
        moved = sum(1 for k in keys
                    if before.owner(k) != after.owner(k)
                    and after.owner(k) != "s3")
        assert moved == 0

    def test_shard_map_roundtrip(self):
        smap = make_shard_map([("s0", "127.0.0.1", 1001),
                               ("s1", "127.0.0.1", 1002)])
        assert smap["version"] == 1
        ring = ring_of(smap)
        assert ring.owner("anything") in ("s0", "s1")

    @pytest.mark.parametrize("shards,vnodes", [
        (["s0", "s1"], 64), (["s0", "s1", "s2", "s3"], 64),
        (["a", "b", "c"], 16), ([f"s{i}" for i in range(16)], 64)])
    def test_owner_equals_reference_over_1000_names(self, shards, vnodes):
        port, ref = HashRing(shards, vnodes), RefHashRing(shards, vnodes)
        names = [f"exp-{i}" for i in range(1000)] + ["", "é-ü", "x" * 300]
        assert [port.owner(n) for n in names] == [ref.owner(n)
                                                   for n in names]
        smap = [(s, "127.0.0.1", 1000 + i) for i, s in enumerate(shards)]
        assert make_shard_map(smap, vnodes) == ref_make_shard_map(smap,
                                                                  vnodes)
        p, r = ring_of(make_shard_map(smap, vnodes)), ref_ring_of(
            ref_make_shard_map(smap, vnodes))
        assert [p.owner(n) for n in names] == [r.owner(n) for n in names]


class TestExperimentOf:
    def test_routing_key_extraction(self):
        assert experiment_of("reserve", {"experiment": "e1"}) == "e1"
        assert experiment_of("create_experiment",
                             {"config": {"name": "e2"}}) == "e2"
        assert experiment_of("register",
                             {"trial": {"experiment": "e3"}}) == "e3"
        assert experiment_of("load_experiment", {"name": "e4"}) == "e4"

    def test_pan_shard_ops_have_no_key(self):
        assert experiment_of("ping", {}) is None
        assert experiment_of("list_experiments", {}) is None


class TestShardedServing:
    def test_new_client_routes_directly_to_both_shards(self, sup):
        host, port = sup.address
        c = _client(host, port)
        c.ping()
        assert c._ring is not None, "shard map not learned from caps"
        names = _two_exp_names(sup.shard_map, prefix="new")
        assert len(names) == 2
        for nm in names.values():
            _configure(c, nm, 3)
            _drain(c, nm, 3)
        for nm in names.values():
            assert c.count(nm, "completed") == 3
        # pan-shard read merges across shards
        listed = c.list_experiments()
        assert set(names.values()) <= set(listed)

    def test_old_client_completes_trials_through_router(self, sup):
        # rolling upgrade, direction 1: a client that never reads the
        # shard_map cap keeps working through the router's relay
        host, port = sup.address
        c = _client(host, port)
        c._caps = ("count", "fetch_completed_since", "worker_cycle")
        names = _two_exp_names(sup.shard_map, prefix="old")
        for nm in names.values():
            _configure(c, nm, 3)
            _drain(c, nm, 3)
        assert c._ring is None  # never learned the map
        for nm in names.values():
            assert c.count(nm, "completed") == 3

    def test_new_client_degrades_against_unsharded_server(self):
        # rolling upgrade, direction 2: no shard_map cap, direct mode
        with CoordServer(device="cpu") as s:
            host, port = s.address
            c = _client(host, port)
            r = c.ping()
            assert "shard_map" not in r["caps"]
            assert c._ring is None
            c.create_experiment({"name": "plain", "max_trials": 2})
            c.register(Trial(params={"x": 0.5}, experiment="plain"))
            assert c.count("plain") == 1

    def test_wrong_shard_error_refreshes_map_and_retries(self, sup):
        # a client seeded at ONE shard's own address gets WrongShardError
        # for the other shard's experiments, learns the map from that
        # shard's ping and retries at the owner
        names = _two_exp_names(sup.shard_map, prefix="ws")
        addrs = {s["id"]: (s["host"], s["port"])
                 for s in sup.shard_map["shards"]}
        (sid_a, nm_a), (sid_b, nm_b) = sorted(names.items())
        c = _client(*addrs[sid_a])
        # caps pinned WITHOUT shard_map so the first B-owned op takes the
        # WrongShardError → refresh → retry path
        c._caps = ("count", "fetch_completed_since", "worker_cycle")
        assert c._ring is None
        c.create_experiment({"name": nm_b, "max_trials": 2})  # B-owned
        assert c._ring is not None, "map not refreshed on WrongShard"
        c.register(Trial(params={"x": 0.1}, experiment=nm_b))
        assert c.count(nm_b) == 1
        c.create_experiment({"name": nm_a, "max_trials": 2})
        assert c.count(nm_a) == 0

    def test_shared_client_routes_concurrently(self, sup):
        # N threads drain one experiment per shard through ONE client
        host, port = sup.address
        c = _client(host, port)
        c.ping()
        names = list(_two_exp_names(sup.shard_map, "mt").values())
        for nm in names:
            _configure(c, nm, 4)
        errors = []

        def drain(nm, w):
            try:
                _drain(c, nm, 4, worker=w)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=drain, args=(nm, f"w{i}"))
                   for i, nm in enumerate(names * 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        if errors:
            raise errors[0]
        for nm in names:
            assert c.count(nm, "completed") == 4

    def test_each_shard_owns_its_process_and_device(self, sup):
        pings = {}
        for sid, addr in sup.shard_addresses().items():
            pings[sid] = _client(*addr).ping()
        assert {p["shard_id"] for p in pings.values()} == set(pings)
        assert len({p["pid"] for p in pings.values()}) == 2
        # a shard spawned with --device cpu stays there
        assert {p["device"] for p in pings.values()} == {"cpu"}
        # the router's ping carries the map but no single shard's identity
        via = _client(*sup.address).ping()
        assert "shard_map" in via["caps"] and "pid" not in via
        assert "shard_id" not in via


class TestSupervisorLifecycle:
    def test_failed_start_reaps_spawned_shards(self):
        # a start() that dies AFTER spawning (the router's public port is
        # already bound) must not leak shard subprocesses
        blocker = socket.socket()
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        try:
            sup = ShardSupervisor(2, port=port, restart=False, device="cpu")
            with pytest.raises(OSError):
                sup.start()
            with sup._procs_lock:
                procs = list(sup._all_procs)
            assert procs, "shards were never spawned — vacuous test"
            for p in procs:
                assert p.poll() is not None, "leaked shard subprocess"
        finally:
            blocker.close()

    def test_start_raises_without_cuda_unless_given_cpu(self):
        # the default device is cuda: each shard resolves it in its own
        # process and exits before its ready line on a machine without
        # CUDA; the start fails at once and reaps both
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        sup = ShardSupervisor(2, restart=False, router=False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sup.start()
        with sup._procs_lock:
            procs = list(sup._all_procs)
        assert len(procs) == 2
        for p in procs:
            assert p.poll() is not None

    def test_shard_main_refuses_cuda_without_it(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        smap = make_shard_map([("s0", "127.0.0.1", _free_port())])
        proc = subprocess.run(
            [sys.executable, "-m", "metaopt_tpu_torch.coord.shards",
             "--shard-id", "s0", "--port", str(smap["shards"][0]["port"]),
             "--shard-map", json.dumps(smap)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert "coordinator ready" not in proc.stdout


class TestRouterFanout:
    def test_list_experiments_merged_and_sorted(self, sup):
        host, port = sup.address
        old = _client(host, port)
        old._caps = ("count", "fetch_completed_since", "worker_cycle")
        names = _two_exp_names(sup.shard_map, prefix="merge")
        for nm in names.values():
            old.create_experiment({"name": nm, "max_trials": 1})
        listed = old.list_experiments()
        assert set(names.values()) <= set(listed)
        assert listed == sorted(listed)
