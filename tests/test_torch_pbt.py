"""The port's PBT against the reference's.

PBT draws with numpy only (the base rung from the algorithm's generator,
each exploit/explore from a generator seeded by a blake2b hash of the
source trial's id), so the two must agree exactly: the same seed and
stream of completed trials give identical continuations (params and
``_parent``), rung tables and state dicts at every step, after a restart
that replays the ledger, and across ``state_dict`` round trips. The
reference's ``tests/unit/test_pbt.py`` contracts are restated against the
port, with ``client.checkpoint_paths``'s cold start.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.algo.pbt import _exploit_seed as ref_exploit_seed
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import PBT, make_algorithm
from metaopt_tpu_torch.algo.pbt import _exploit_seed
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space

REPO = Path(__file__).resolve().parents[1]
SPEC = {"lr": "loguniform(1e-5, 1e-1)", "mom": "uniform(0, 1)",
        "opt": "choices(['sgd', 'adam'])", "epochs": "fidelity(1, 8, base=2)"}


def completed(point, objective, space, trial_cls=Trial, tid=None):
    params = {k: v for k, v in point.items() if k != "_parent"}
    t = trial_cls(params=params, experiment="e", parent=point.get("_parent"))
    if tid:
        t.id = tid
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


def objective(p):
    return ((np.log10(p["lr"]) + 3) ** 2 + (p["mom"] - 0.9) ** 2
            + (0.3 if p["opt"] == "sgd" else 0.0) + 1.0 / p["epochs"])


def drive(port, ref, space, ref_space, steps, seed):
    rng = np.random.default_rng(seed)
    inflight, history, parents = [], [], []
    for step in range(steps):
        num = int(rng.integers(1, 5))
        got, want = port.suggest(num), ref.suggest(num)
        assert got == want, step
        parents += [p["_parent"] for p in got if "_parent" in p]
        inflight += got
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done, inflight = inflight[:k], inflight[k:]
        trials = [completed(p, objective(p), space) for p in done]
        history += trials
        port.observe(trials)
        ref.observe([completed(p, objective(p), ref_space, RefTrial) for p in done])
        assert port.state_dict() == ref.state_dict(), step
        assert port.rung_table == ref.rung_table and port.is_done == ref.is_done, step
    return history, parents


@pytest.mark.parametrize("config", [
    {"population_size": 6, "seed": 0, "min_cohort": 3, "exploit_quantile": 0.25},
    {"population_size": 8, "seed": 2, "exploit_quantile": 0.5, "resample_prob": 0.5},
    {"population_size": 4, "seed": 9, "min_cohort": 2, "perturb_scale": 0.05},
], ids=["pbt.yaml", "half-exploit", "small"])
def test_port_matches_reference_exactly(config):
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    port = make_algorithm(space, {"pbt": dict(config)})
    ref = ref_make_algorithm(ref_space, {"pbt": dict(config)})
    assert port.configuration == ref.configuration
    assert port.cohort_size == ref.cohort_size
    history, parents = drive(port, ref, space, ref_space, 80, seed=7)
    by_id = {t.id: t for t in history}
    # at least one continuation took another member's weights (an exploit)
    assert any(t.parent and by_id[t.parent].lineage != t.lineage for t in history
               if t.parent in by_id)
    assert port.rung_table[-1]["n"] > 0


def test_replay_and_state_round_trip_continue_the_reference_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"pbt": {"population_size": 5, "seed": 4, "min_cohort": 3}}
    live = make_algorithm(space, dict(cfg))
    ref_live = ref_make_algorithm(ref_space, dict(cfg))
    history, _ = drive(live, ref_live, space, ref_space, 15, seed=1)
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    port.observe(history)
    ref.observe([completed({**t.params, "_parent": t.parent} if t.parent else t.params,
                           t.objective, ref_space, RefTrial) for t in history])
    assert port.state_dict() == ref.state_dict()
    drive(port, ref, space, ref_space, 15, seed=2)
    again = make_algorithm(space, dict(cfg))
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    again.rng.bit_generator.state = port.rng.bit_generator.state
    drive(again, ref, space, ref_space, 20, seed=3)


def test_exploit_seed_equals_the_reference_and_is_stable_across_interpreters():
    for tid in ("trial-abc123", "", "0" * 32):
        assert _exploit_seed(tid) == ref_exploit_seed(tid)
    assert _exploit_seed("trial-abc123") == 1852549890743809802
    env = dict(os.environ, PYTHONHASHSEED="424242", PYTHONPATH=str(REPO))
    out = subprocess.check_output(
        [sys.executable, "-c", "from metaopt_tpu_torch.algo.pbt import _exploit_seed;"
         "print(_exploit_seed('trial-abc123'))"], env=env, cwd=REPO)
    assert int(out) == 1852549890743809802


class TestPBT:
    def test_seeds_population_at_base_rung(self):
        space = build_space(SPEC)
        algo = PBT(space, seed=1, population_size=4)
        pts = algo.suggest(10)
        assert len(pts) == 4 and all(p["epochs"] == 1 and p in space for p in pts)
        assert algo.suggest(1) == []

    def test_continues_member_async_without_barrier(self):
        space = build_space(SPEC)
        algo = PBT(space, seed=2, population_size=4, min_cohort=3)
        pts = algo.suggest(4)
        algo.observe([completed(pts[0], 0.5, space, tid="trial-0")])
        nxt = algo.suggest(1)
        assert nxt[0]["epochs"] == 2 and nxt[0]["_parent"] == "trial-0"
        assert (nxt[0]["lr"], nxt[0]["mom"]) == (pts[0]["lr"], pts[0]["mom"])

    def test_bottom_member_exploits_top(self):
        space = build_space(SPEC)
        algo = PBT(space, seed=3, population_size=4, min_cohort=3, exploit_quantile=0.25)
        pts = algo.suggest(4)
        algo.observe([completed(p, o, space, tid=f"trial-{i}")
                      for i, (p, o) in enumerate(zip(pts, [0.1, 0.2, 0.3, 9.9]))])
        conts = algo.suggest(4)
        parents = {c["_parent"] for c in conts}
        assert "trial-3" not in parents and "trial-0" in parents
        keep = [c for c in conts if c["_parent"] == "trial-0"]
        assert any((c["lr"], c["mom"]) != (pts[0]["lr"], pts[0]["mom"]) for c in keep)
        assert all(c["epochs"] == 2 for c in conts)

    def test_is_done_when_population_tops_out(self):
        space = build_space(SPEC)
        algo = PBT(space, seed=4, population_size=2, min_cohort=2)
        tid = 0
        for _ in range(8):
            if algo.is_done:
                break
            trials = []
            for p in algo.suggest(4):
                trials.append(completed(p, float(tid), space, tid=f"t{tid}"))
                tid += 1
            algo.observe(trials)
        assert algo.is_done

    def test_replay_does_not_reseed(self):
        space = build_space(SPEC)
        algo = PBT(space, seed=5, population_size=3, min_cohort=3)
        trials = [completed(p, float(i), space, tid=f"t{i}")
                  for i, p in enumerate(algo.suggest(3))]
        replay = PBT(space, seed=5, population_size=3, min_cohort=3)
        replay.observe(trials)
        assert replay._seeded == 3
        assert all(p["epochs"] == 2 for p in replay.suggest(5))


def test_empty_parent_dir_is_cold_start(tmp_path, monkeypatch):
    from metaopt_tpu_torch import client

    root = str(tmp_path / "ckpt")
    monkeypatch.setenv(client.CKPT_ROOT_ENV, root)
    monkeypatch.setenv(client.TRIAL_INFO_ENV, json.dumps(
        {"id": "donor", "experiment": "e", "params": {}}))
    client.checkpoint_paths()
    monkeypatch.setenv(client.TRIAL_INFO_ENV, json.dumps(
        {"id": "kid", "experiment": "e", "params": {}, "parent": "donor"}))
    assert client.checkpoint_paths()[1] is None  # empty donor dir = cold start
    with open(os.path.join(root, "donor", "w.json"), "w") as f:
        f.write("{}")
    assert client.checkpoint_paths()[1].endswith("donor")
