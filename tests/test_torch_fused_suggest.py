"""Fleet-fused suggest plane on the port: fused ≡ serial bit-identity +
fallback matrix (the reference's ``tests/unit/test_fused_suggest.py``,
restated), plus the port's own: a bucket launch's op count does not grow
with the bucket (apart from each member's draws), and a bucket launch that
raises is not replaced by solo launches.

The determinism contract (coord/fuser.py): a suggestion served from a
fused bucket launch is BIT-identical to what the experiment's own refill
would have produced — same prefetch pool contents, same PRNG stream
positions, same untransformed points. The tests build TWIN algorithms
(same seed, same observations), serve one through :class:`SuggestFuser`
and the other through its own per-experiment launch path, and compare
the served streams exactly (``==`` on the untransformed param dicts —
float equality on purpose: the contract is bitwise on the CPU, where every
instance here runs).

SuggestAhead's automatic post-observe refill is suppressed on every
instance (``_suggest_ahead_ready`` → False) so no background thread
races the legs for the demand; the live-server race is exercised by the
chaos suites, not here.
"""

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.algo import GPBO, TPE
from metaopt_tpu_torch.coord.fuser import SuggestFuser
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space


def completed(space, params, objective, experiment="e"):
    t = Trial(params=params, experiment=experiment)
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


def tpe_space():
    return build_space(
        {"x": "uniform(-10, 10)", "c": "choices(['a', 'b', 'c'])"})


def gp_space():
    return build_space({"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"})


def feed_tpe(space, algo, n_obs, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n_obs):
        params = {"x": float(rng.uniform(-10, 10)),
                  "c": ["a", "b", "c"][int(rng.integers(3))]}
        algo.observe([completed(space, params, float(rng.uniform()))])


def feed_gp(space, algo, n_obs, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n_obs):
        params = {"x": float(rng.uniform(-5, 5)),
                  "y": float(rng.uniform(-5, 5))}
        algo.observe([completed(space, params,
                                float(params["x"] ** 2 + params["y"] ** 2))])


def quiet(algo):
    """Suppress the automatic post-observe refill thread (determinism)."""
    algo._suggest_ahead_ready = lambda: False
    return algo


def drain_pool(algo):
    """Empty the prefetch at the live fit — the post-observe demand state."""
    with algo._kernel_lock:
        algo._prefetch = []
        algo._prefetch_n_obs = len(algo._y)


def make_tpe_twins(counts, seeds, space=None, **kw):
    """(fused_fleet, serial_fleet): pairwise-identical TPE instances."""
    space = space or tpe_space()
    fused, serial = [], []
    for i, (n_obs, seed) in enumerate(zip(counts, seeds)):
        pair = []
        for _ in range(2):
            a = quiet(TPE(space, seed=seed, n_initial_points=5, device="cpu", **kw))
            feed_tpe(space, a, n_obs, seed=1000 + i)
            pair.append(a)
        fused.append((f"exp{i}", pair[0]))
        serial.append((f"exp{i}", pair[1]))
    return fused, serial


class TestTPEFusedIdentity:
    def test_fused_equals_serial_mixed_counts(self):
        # mixed observation counts in one sweep: 9/10/11 share a pad
        # bucket, 12 opens a second (different n_bad_pad) — the fuser
        # must keep them apart and still serve every member bit-exact
        counts = [9, 11, 9, 10, 12, 9]
        fused, serial = make_tpe_twins(counts, [100 + i for i in range(6)])
        stats = SuggestFuser(bucket_max=16).fuse(fused)
        assert stats["fused"] == len(counts)
        assert stats["fallback"] == 0
        assert stats["launches"] == 2  # {9,10,11} bucket + {12} bucket
        # full pool drain: every banked suggestion must match, not just
        # the first served point
        for (_, fa), (_, sa) in zip(fused, serial):
            for _ in range(fa.pool_prefetch):
                assert fa.suggest(1) == sa.suggest(1)

    def test_fused_pool_replays_serial_stream_across_refits(self):
        # fuse, serve, observe more (fit moves), fuse again: the stream
        # stays pairwise identical through a fit change
        fused, serial = make_tpe_twins([9, 9], [7, 8])
        fuser = SuggestFuser()
        assert fuser.fuse(fused)["fused"] == 2
        for (_, fa), (_, sa) in zip(fused, serial):
            assert fa.suggest(2) == sa.suggest(2)
        space = fused[0][1].space
        for i, ((_, fa), (_, sa)) in enumerate(zip(fused, serial)):
            params = {"x": 1.0 + i, "c": "b"}
            fa.observe([completed(space, params, 0.5)])
            sa.observe([completed(space, params, 0.5)])
        assert fuser.fuse(fused)["fused"] == 2
        for (_, fa), (_, sa) in zip(fused, serial):
            assert fa.suggest(3) == sa.suggest(3)

    def test_pending_overlay_identical(self):
        # lie rows (parallel_strategy) ride into the fused snapshot the
        # same way they ride into a solo launch
        fused, serial = make_tpe_twins(
            [10, 10], [21, 22], parallel_strategy="mean")
        space = fused[0][1].space
        for i, ((_, fa), (_, sa)) in enumerate(zip(fused, serial)):
            pend = Trial(params={"x": 3.25 + i, "c": "a"}, experiment="e")
            pend.lineage = space.hash_point(pend.params)
            pend.transition("reserved")
            fa.set_pending([pend])
            sa.set_pending([pend])
        assert SuggestFuser().fuse(fused)["fused"] == 2
        for (_, fa), (_, sa) in zip(fused, serial):
            assert fa.suggest(2) == sa.suggest(2)

    def test_singleton_chunk_falls_back_untouched(self):
        # a bucket of one is not worth a fleet launch: the fuser aborts
        # the snapshot and the experiment's own path serves EXACTLY the
        # stream it would have served had the fuser never existed
        fused, serial = make_tpe_twins([9], [42])
        stats = SuggestFuser().fuse(fused)
        assert stats == {"launches": 0, "fused": 0, "fallback": 1}
        assert fused[0][1].suggest(2) == serial[0][1].suggest(2)

    def test_fuse_abort_unallocates_pool_index(self):
        space = tpe_space()
        a = quiet(TPE(space, seed=3, n_initial_points=5, device="cpu"))
        feed_tpe(space, a, 9, seed=9)
        with a._launch_lock:
            before = a._pool_idx
            snap = a.fuse_snapshot()
            assert a._pool_idx == before + 1
            a.fuse_abort(snap)
            assert a._pool_idx == before

    def test_random_phase_not_fused(self):
        space = tpe_space()
        a = quiet(TPE(space, seed=1, n_initial_points=5, device="cpu"))
        feed_tpe(space, a, 3, seed=1)  # still in the random phase
        stats = SuggestFuser().fuse([("e0", a)])
        assert stats["fused"] == 0
        assert len(a.suggest(1)) == 1  # random serving unaffected

    def test_fresh_pool_means_no_demand(self):
        fused, _ = make_tpe_twins([9, 9], [5, 6])
        fuser = SuggestFuser()
        assert fuser.fuse(fused)["fused"] == 2
        # pools are full and fresh now: a second sweep must be a no-op
        assert fuser.fuse(fused) == {
            "launches": 0, "fused": 0, "fallback": 0}

    def test_commit_discarded_when_fit_moves(self):
        # fit moves between snapshot and commit → the slice must be
        # discarded (a pool computed against a stale fit must never be
        # served) and the index burn must not corrupt later streams
        fused, serial = make_tpe_twins([9, 9], [11, 12])
        (_, a0), (_, a1) = fused
        snaps, algos = [], [a0, a1]
        for a in algos:
            a._launch_lock.acquire()
            snaps.append(a.fuse_snapshot())
        out = SuggestFuser()._launch_bucket(
            "tpe", [(f"e{i}", a, s)
                    for i, (a, s) in enumerate(zip(algos, snaps))])
        space = a0.space
        a0.observe([completed(space, {"x": 0.5, "c": "c"}, 0.1)])
        assert a0.fuse_commit(snaps[0], out[0]) is False
        assert a1.fuse_commit(snaps[1], out[1]) is True
        for a in algos:
            a._launch_lock.release()
        assert a0.telemetry()["fused_discards"] == 1
        # a1 committed: stream identical to its serial twin
        assert a1.suggest(2) == serial[1][1].suggest(2)

    def test_incompatible_spaces_bucket_separately(self):
        s1 = tpe_space()
        s2 = build_space({"x": "uniform(0, 1)", "z": "uniform(0, 1)",
                          "w": "uniform(0, 1)"})
        a1 = quiet(TPE(s1, seed=1, n_initial_points=5, device="cpu"))
        a2 = quiet(TPE(s2, seed=2, n_initial_points=5, device="cpu"))
        feed_tpe(s1, a1, 9, seed=1)
        rng = np.random.default_rng(2)
        for _ in range(9):
            params = {"x": float(rng.uniform()), "z": float(rng.uniform()),
                      "w": float(rng.uniform())}
            a2.observe([completed(s2, params, float(rng.uniform()))])
        # different d → different static keys → two singleton chunks,
        # both falling back (never cross-batched into one program)
        stats = SuggestFuser().fuse([("e1", a1), ("e2", a2)])
        assert stats == {"launches": 0, "fused": 0, "fallback": 2}


class TestGPFusedIdentity:
    def _twins(self, counts, seeds):
        space = gp_space()
        fused, serial = [], []
        for i, (n_obs, seed) in enumerate(zip(counts, seeds)):
            pair = []
            for _ in range(2):
                a = quiet(GPBO(space, seed=seed, n_initial_points=5,
                               n_candidates=64, device="cpu"))
                feed_gp(space, a, n_obs, seed=2000 + i)
                pair.append(a)
            fused.append((f"gp{i}", pair[0]))
            serial.append((f"gp{i}", pair[1]))
        return fused, serial

    def test_fused_equals_serial(self):
        counts = [9, 10, 9, 11]
        fused, serial = self._twins(counts, [300 + i for i in range(4)])
        # prime: one serial suggest fits factor+params on BOTH twins
        # (the fused plane only batches surrogate-as-input acquisition)
        for (_, fa), (_, sa) in zip(fused, serial):
            assert fa.suggest(1) == sa.suggest(1)
            drain_pool(fa)
            drain_pool(sa)
        stats = SuggestFuser(bucket_max=16).fuse(fused)
        assert stats["fused"] == len(counts)
        assert stats["fallback"] == 0
        for (_, fa), (_, sa) in zip(fused, serial):
            for _ in range(3):
                assert fa.suggest(1) == sa.suggest(1)

    def test_gp_mid_refit_not_fused(self):
        # no resident factor yet (never suggested at this fit) → the
        # surrogate-as-input precondition fails → the fuser skips the
        # experiment entirely: no pool index is allocated, and nothing
        # counts as fallback (fallback = demand the fuser CLAIMED and
        # handed back; an ineligible member is never claimed)
        fused, _ = self._twins([9, 9], [55, 56])
        for _, a in fused:
            drain_pool(a)
        stats = SuggestFuser().fuse(fused)
        assert stats == {"launches": 0, "fused": 0, "fallback": 0}
        # the per-experiment path still serves (and installs the factor)
        assert len(fused[0][1].suggest(1)) == 1


class TestBucketing:
    def test_bucket_max_rounds_down_to_pow2(self):
        assert SuggestFuser(bucket_max=48).bucket_max == 32
        assert SuggestFuser(bucket_max=32).bucket_max == 32
        assert SuggestFuser(bucket_max=3).bucket_max == 2
        assert SuggestFuser(bucket_max=1).bucket_max == 2

    def test_chunking_respects_bucket_max(self):
        counts = [9] * 5
        fused, serial = make_tpe_twins(
            counts, [400 + i for i in range(5)])
        stats = SuggestFuser(bucket_max=2).fuse(fused)
        # 5 members at cap 2 → chunks of 2/2/1: two launches, the
        # trailing singleton falls back
        assert stats["launches"] == 2
        assert stats["fused"] == 4
        assert stats["fallback"] == 1
        for (_, fa), (_, sa) in zip(fused, serial):
            assert fa.suggest(1) == sa.suggest(1)

    def test_telemetry_counters(self):
        fused, _ = make_tpe_twins([9, 9, 9], [500, 501, 502])
        fuser = SuggestFuser()
        fuser.fuse(fused)
        tel = fuser.telemetry()
        assert tel["bucket_launches"] == 1
        assert tel["fused_experiments"] == 3
        assert tel["last_buckets"] == 1
        assert tel["last_occupancy"] == 3.0
        for _, a in fused:
            assert a.telemetry()["fused_commits"] == 1


# -- the port's own properties -------------------------------------------


def _bucket(n_members, seed=600):
    """``n_members`` TPE members at one static key (9 observations each),
    snapshotted under their launch locks."""
    fused, _ = make_tpe_twins([9] * n_members, [seed + i for i in range(n_members)])
    chunk = []
    for name, a in fused:
        a._launch_lock.acquire()
        chunk.append((name, a, a.fuse_snapshot()))
    return chunk


def _release(chunk):
    for _n, a, _s in chunk:
        a._launch_lock.release()


def _top_level_ops(fn):
    """Names of the top-level torch ops ``fn`` runs (views inside an op,
    such as the inputs' unsqueezes within one ``stack``, are nested)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(e.name for e in prof.events() if e.cpu_parent is None)


def _gp_bucket(n_members):
    space = gp_space()
    chunk = []
    for i in range(n_members):
        a = quiet(GPBO(space, seed=700 + i, n_initial_points=5, n_candidates=64,
                       device="cpu"))
        feed_gp(space, a, 9, seed=800 + i)
        a.suggest(1)                      # installs factor + params
        drain_pool(a)
        a._launch_lock.acquire()
        chunk.append((f"gp{i}", a, a.fuse_snapshot()))
    return chunk


@pytest.mark.parametrize("family", ["tpe", "gp"])
def test_a_bucket_launch_runs_the_same_ops_at_every_width(monkeypatch, family):
    """B 1, 4 and 16 run the same top-level ops once the members' draws
    are made; the draws themselves are the only part that grows with B:
    four RNG ops a member for TPE, two for GP-BO."""
    from metaopt_tpu_torch.algo import gp_bo
    from metaopt_tpu_torch.ops import tpe_math

    draw_mod, draw_fn = ((tpe_math, "pool_draws") if family == "tpe"
                         else (gp_bo, "gp_pool_draws"))
    plain = getattr(draw_mod, draw_fn)
    memo = {}

    def made_before(*args, **kw):
        key = args[:2]
        if key not in memo:
            memo[key] = plain(*args, **kw)
        return memo[key]

    counts, draw_ops = {}, {}
    for n in (1, 4, 16):
        chunk = _bucket(n) if family == "tpe" else _gp_bucket(n)
        try:
            assert all(s is not None for _n, _a, s in chunk)

            def launch():
                return SuggestFuser(bucket_max=32)._launch_bucket(family, chunk)

            ops = _top_level_ops(launch)
            draw_ops[n] = sum(o in ("aten::rand", "aten::randn") for o in ops)
            monkeypatch.setattr(draw_mod, draw_fn, made_before)
            launch()                                   # make the draws once
            counts[n] = _top_level_ops(launch)
            monkeypatch.setattr(draw_mod, draw_fn, plain)
        finally:
            _release(chunk)
    assert counts[1] == counts[4] == counts[16]
    per_member = 4 if family == "tpe" else 2
    assert draw_ops == {n: per_member * n for n in (1, 4, 16)}


def test_a_failed_bucket_launch_is_not_replaced_by_solo_launches(monkeypatch):
    """The launch error reaches the caller, every member gets its pool
    index back, nothing is banked, and no solo launch ran in its place."""
    fused, serial = make_tpe_twins([9, 9, 9], [900, 901, 902])
    fuser = SuggestFuser()

    def broken(family, chunk):
        raise RuntimeError("bucket launch failed on the device")

    monkeypatch.setattr(fuser, "_launch_bucket", broken)
    before = [(a._pool_idx, a._launches) for _n, a in fused]
    with pytest.raises(RuntimeError, match="bucket launch failed"):
        fuser.fuse(fused)
    assert [(a._pool_idx, a._launches) for _n, a in fused] == before
    assert all(not a._prefetch for _n, a in fused)
    assert all(not a._launch_lock._is_owned() for _n, a in fused)
    assert fuser.telemetry()["launch_errors"] == 1
    # the members' own refills still serve the stream a never-attempted
    # fusion leaves
    for (_, fa), (_, sa) in zip(fused, serial):
        assert fa.suggest(2) == sa.suggest(2)


def test_fleet_launch_rows_equal_solo_launches_bit_for_bit():
    """``tpe_suggest_fleet`` row b equals the member's own
    ``tpe_suggest_fused`` at mixed live counts under one pad."""
    from metaopt_tpu_torch.ops.tpe_math import tpe_suggest_fleet, tpe_suggest_fused

    chunk = _bucket(6, seed=950)
    try:
        snaps = [s for _n, _a, s in chunk]
        ar = [s.arrays for s in snaps]
        sk = snaps[0].static_key
        kw = dict(n_cand=sk[2], n_out=sk[3], kmax=sk[4], equal_weight=sk[5],
                  n_good_pad=sk[6], n_bad_pad=sk[7])
        cols = {k: [a[k] for a in ar] for k in ar[0]}
        fleet = tpe_suggest_fleet(
            cols["X"], cols["y"], cols["n"], cols["count"], cols["fit_seed"],
            cols["n_choices"], cols["cont_mask"], cols["gamma"], cols["prior_weight"],
            cols["full_weight_num"], cols["n_prior"], cols["transfer_discount"], **kw)
        for b, a in enumerate(ar):
            solo = tpe_suggest_fused(
                a["X"], a["y"], a["n"], a["count"], a["fit_seed"], a["n_choices"],
                a["cont_mask"], a["gamma"], a["prior_weight"], a["full_weight_num"],
                a["n_prior"], a["transfer_discount"], **kw)
            assert torch.equal(fleet[b], solo)
    finally:
        _release(chunk)
