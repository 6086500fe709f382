"""The coordinator's multi-tenant service plane, restated from the
reference's ``tests/functional/test_coord_multitenant.py`` against the
port: fair produce scheduling (fake clock), the admission gate, and lazy
eviction/hydration (bit-identical round trips, status counts answered from
the stub, the LRU residency budget). ``FairProduceScheduler`` and
``jain_index`` are also held exact against the reference's for the same
injected clock and request sequence. The reference's transfer-prior tests
belong to the producer (ported and tested with the ledger slice) and its
kill -9 eviction sweep is a chaos sweep; neither is restated here.
"""

import time

import pytest

from metaopt_tpu.coord.tenancy import FairProduceScheduler as RefScheduler
from metaopt_tpu.coord.tenancy import jain_index as ref_jain
from metaopt_tpu_torch.coord import CoordLedgerClient
from metaopt_tpu_torch.coord import CoordServer as _CoordServer
from metaopt_tpu_torch.coord.tenancy import FairProduceScheduler, jain_index
from metaopt_tpu_torch.ledger import Trial
from metaopt_tpu_torch.ledger.backends import (
    AdmissionError,
    DuplicateExperimentError,
)



class CoordServer(_CoordServer):
    """The port's server with its hosted algorithms on the CPU."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


# -- fair produce scheduling (fake clock, no server) ----------------------


def test_jain_index():
    assert jain_index([]) == 1.0
    assert jain_index([0, 0, 0]) == 1.0
    assert jain_index([5, 5, 5, 5]) == pytest.approx(1.0)
    # one tenant taking everything floors at 1/n
    assert jain_index([12, 0, 0, 0]) == pytest.approx(0.25)
    assert 0.25 < jain_index([8, 2, 2, 2]) < 1.0


class TestFairProduceScheduler:
    def test_single_tenant_work_conservation(self):
        s = FairProduceScheduler(window_s=10.0, burst=2)
        assert all(s.admit("solo", now=0.01 * i) for i in range(200))
        assert s.total_granted["solo"] == 200
        assert s.total_denied.get("solo", 0) == 0

    def test_hot_tenant_capped_when_contended(self):
        s = FairProduceScheduler(window_s=100.0, burst=2)
        assert s.admit("small", now=0.0)
        assert s.admit("hot", now=0.0)
        # equal weights, share 0.5: the hot tenant's holdings stall at
        # held >= 0.5*(held+2)+2, i.e. 6 grants, while small sits at 1
        outcomes = [s.admit("hot", now=0.1) for _ in range(50)]
        assert s.total_granted["hot"] == 6
        assert outcomes.count(False) == 45
        # the small tenant is nowhere near its share: still admitted
        assert s.admit("small", now=0.2)
        assert s.total_denied.get("small", 0) == 0

    def test_weights_shift_the_cap(self):
        lo = FairProduceScheduler(window_s=100.0, burst=0)
        hi = FairProduceScheduler(
            weights={"hot": 3.0}, window_s=100.0, burst=0)
        for s in (lo, hi):
            s.admit("small", now=0.0)
            for _ in range(100):
                s.admit("hot", now=0.1)
        assert hi.total_granted["hot"] > lo.total_granted["hot"]

    def test_absolute_quota_overrides_fair_share(self):
        s = FairProduceScheduler(quotas={"batch": 2}, window_s=100.0)
        # even alone (work conservation would admit), the quota caps it
        grants = [s.admit("batch", now=0.0) for _ in range(5)]
        assert grants == [True, True, False, False, False]
        # the window roll refills the quota
        assert s.admit("batch", now=200.0)

    def test_idle_tenant_ages_out_of_the_active_set(self):
        s = FairProduceScheduler(
            window_s=1000.0, burst=2, active_window_s=2.0)
        s.admit("small", now=0.0)
        while s.admit("hot", now=0.1):
            pass  # drive hot to its contended cap
        denied = s.total_denied["hot"]
        assert denied > 0
        # small stops requesting; once it ages out the active set is
        # {hot} alone and every request is granted again — capacity
        # shifts, it is never parked
        assert s.admit("hot", now=5.0)
        assert s.total_denied["hot"] == denied

    def test_stats_shape(self):
        s = FairProduceScheduler(weights={"a": 2.0}, window_s=100.0)
        s.admit("a", now=0.0)
        s.admit("b", now=0.0)
        st = s.stats()
        assert st["a"] == {"granted": 1, "denied": 0, "weight": 2.0}
        assert st["b"]["weight"] == 1.0


# -- admission control ----------------------------------------------------


def test_create_experiment_admission_gate():
    with CoordServer(max_experiments=3,
                     max_experiments_per_tenant=2) as s:
        host, port = s.address
        c = CoordLedgerClient(host=host, port=port)

        def doc(name, tenant):
            return {"name": name, "tenant": tenant,
                    "space": {"x": "uniform(0, 1)"}, "max_trials": 10}

        c.create_experiment(doc("a-1", "acme"))
        c.create_experiment(doc("a-2", "acme"))
        with pytest.raises(AdmissionError, match="tenant"):
            c.create_experiment(doc("a-3", "acme"))
        c.create_experiment(doc("b-1", "beta"))  # global slot 3
        with pytest.raises(AdmissionError, match="limit 3"):
            c.create_experiment(doc("b-2", "beta"))
        # a lost creation race is NOT an admission failure: the denied
        # doc above must not have consumed a slot, and a duplicate name
        # keeps its own error type
        with pytest.raises(DuplicateExperimentError):
            c.create_experiment(doc("a-1", "acme"))
        assert sorted(c.list_experiments()) == ["a-1", "a-2", "b-1"]


# -- lazy hydration / eviction --------------------------------------------


def _drive(client, name, worker, n):
    """Complete ``n`` trials through the fused worker_cycle loop."""
    complete = None
    done = 0
    for _ in range(n * 20):
        out = client.worker_cycle(name, worker, pool_size=4,
                                  complete=complete)
        complete = None
        t = out["trial"]
        if t is None:
            if out["counts"]["completed"] >= n:
                return
            continue
        t.attach_results([{"name": "objective", "type": "objective",
                           "value": (t.params["x"] - 0.3) ** 2}])
        t.transition("completed")
        complete = {"trial": t.to_dict(), "expected_status": "reserved",
                    "expected_worker": worker}
        done += 1
        if done >= n:
            client.update_trial(t, expected_status="reserved",
                                expected_worker=worker)
            return
    raise AssertionError(f"never completed {n} trials")


def test_evict_hydrate_bit_identity(tmp_path):
    """Evict→hydrate restores the hosted algorithm state_dict, the
    journaled reply-cache entries, and in-flight reservations exactly."""
    with CoordServer(host_algorithms=True,
                     evict_dir=str(tmp_path / "evict"),
                     stale_timeout_s=60.0) as s:
        host, port = s.address
        c = CoordLedgerClient(host=host, port=port)
        c.create_experiment({
            "name": "bits", "tenant": "acme",
            "space": {"x": "uniform(0, 1)"}, "max_trials": 100,
            "pool_size": 4,
            "algorithm": {"tpe": {"seed": 3, "n_initial_points": 2}},
        })
        _drive(c, "bits", "w0", 6)
        # leave one reservation in flight across the round-trip
        cyc = c.worker_cycle("bits", "w-held", pool_size=4)
        held = cyc["trial"]
        assert held is not None

        prod, plock = s._producers["bits"]
        with plock:
            prod.produce()  # observe everything completed so far
            state_before = prod.algorithm.state_dict()
        with s._replies_lock:
            replies_before = {
                r: s._replies[r] for r, e in s._reply_exps.items()
                if e == "bits" and r in s._replies}
        docs_before = {t.id: t.to_dict() for t in c.fetch("bits")}
        assert replies_before and docs_before

        assert s.evict_experiment("bits")
        assert "bits" in s._evicted
        assert "bits" not in s._producers

        # first touch hydrates (fetch is not a stub-answerable op)
        docs_after = {t.id: t.to_dict() for t in c.fetch("bits")}
        assert "bits" not in s._evicted
        assert docs_after == docs_before
        assert c.count("bits", status="reserved") == 1
        rdoc = next(d for d in docs_after.values()
                    if d["status"] == "reserved")
        assert rdoc["id"] == held.id and rdoc["worker"] == "w-held"

        prod2, plock2 = s._producers["bits"]
        assert prod2 is not prod  # rebuilt, not leaked
        with plock2:
            assert prod2.algorithm.state_dict() == state_before
        with s._replies_lock:
            replies_after = {
                r: s._replies[r] for r, e in s._reply_exps.items()
                if e == "bits" and r in s._replies}
        for r, reply in replies_before.items():
            assert replies_after.get(r) == reply


def test_status_counts_answer_from_stub_without_hydrating(tmp_path):
    with CoordServer(evict_dir=str(tmp_path / "evict"),
                     stale_timeout_s=60.0) as s:
        host, port = s.address
        c = CoordLedgerClient(host=host, port=port)
        for name, tenant, n in (("cold", "acme", 5), ("warm", "beta", 3)):
            c.create_experiment({
                "name": name, "tenant": tenant,
                "space": {"x": "uniform(0, 1)"}, "max_trials": 100})
            for i in range(n):
                c.register(Trial(params={"x": i / 10.0}, experiment=name))
        assert s.evict_experiment("cold")

        st = c.tenant_stats(include_experiments=True)
        assert st["resident"] == 1 and st["evicted"] == 1
        assert st["tenants"]["acme"]["evicted"] == 1
        assert st["experiments"]["cold"] == {
            "tenant": "acme", "evicted": True, "counts": {"new": 5}}
        assert st["experiments"]["warm"]["counts"] == {"new": 3}
        # count/load_experiment answer from the stub index too
        assert c.count("cold", status="new") == 5
        assert c.count("cold", status="completed") == 0
        # none of the above resurrected anything
        assert "cold" in s._evicted
        assert st["hydrations"] == 0 and s._hydrations == 0


def test_evict_sweep_lru_respects_max_resident(tmp_path):
    with CoordServer(snapshot_path=str(tmp_path / "snap.json"),
                     max_resident=2, stale_timeout_s=60.0,
                     sweep_interval_s=3600.0) as s:
        host, port = s.address
        c = CoordLedgerClient(host=host, port=port)
        for i in range(5):
            c.create_experiment({
                "name": f"lru-{i}", "space": {"x": "uniform(0, 1)"},
                "max_trials": 10})
        # freshen 4 then 3: the sweep must keep the two most recent
        c.count("lru-4")
        time.sleep(0.01)
        c.count("lru-3")
        assert s.evict_sweep() == 3
        assert sorted(s._evicted) == ["lru-0", "lru-1", "lru-2"]
        assert s.evict_sweep() == 0  # idempotent at the budget


# -- transfer priors ------------------------------------------------------


def _completed(led, name, n, seed_x=0.3):
    for i in range(n):
        t = Trial(params={"x": min(1.0, seed_x + 0.01 * i)},
                  experiment=name)
        led.register(t)
        got = led.reserve(name, "seed")
        got.attach_results([{"name": "objective", "type": "objective",
                             "value": (got.params["x"] - 0.3) ** 2}])
        got.transition("completed")
        led.update_trial(got, expected_status="reserved",
                         expected_worker="seed")


def test_scheduler_exact_against_the_reference_for_one_clock_and_stream():
    """Same weights, quotas, window, burst, injected clock and request
    sequence: the same admit/deny stream, stats and grant orders."""
    import random as _random

    rng = _random.Random(17)
    kw = dict(weights={"a": 3.0, "b": 1.0, "c": 0.5}, quotas={"c": 40},
              window_s=0.5, burst=2)
    mine, ref = FairProduceScheduler(**kw), RefScheduler(**kw)
    now = 0.0
    tenants = ["a", "b", "c", "d"]
    for step in range(4000):
        now += rng.choice([0.0, 0.0005, 0.002, 0.05, 0.7])
        t = rng.choice(tenants[: 2 + (step // 1000)])
        assert mine.admit(t, now=now) == ref.admit(t, now=now), step
        if step % 97 == 0:
            active = set(rng.sample(tenants, rng.randint(1, 4)))
            assert mine.grant_order(active) == ref.grant_order(active)
            assert mine.stats() == ref.stats()
    assert mine.stats() == ref.stats()
    for t in tenants:
        assert mine.weight(t) == ref.weight(t)
    for xs in ([], [1.0], [3, 0, 1], [5.0, 5.0, 5.0], [0, 0]):
        assert jain_index(xs) == ref_jain(xs)
