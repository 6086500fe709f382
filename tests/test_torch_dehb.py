"""The port's DEHB against the reference's.

DEHB draws with numpy only, so the two must agree exactly: the same seed
and stream of completed trials give identical suggestions, rung tables and
state dicts at every step, after a restart that replays the ledger, and
across ``state_dict`` round trips. The reference's
``tests/unit/test_dehb.py`` contracts are restated against the port.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import DEHB, make_algorithm
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space

SPEC = {"lr": "loguniform(1e-5, 1e-1)", "mom": "uniform(0, 1)",
        "opt": "choices(['sgd', 'adam'])", "epochs": "fidelity(1, 9, base=3)"}


def completed(params, objective, space, trial_cls=Trial, tid=None):
    t = trial_cls(params=dict(params), experiment="e")
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
    inflight, history = [], []
    for step in range(steps):
        num = int(rng.integers(1, 5))
        got, want = port.suggest(num), ref.suggest(num)
        assert got == want, step
        inflight += got
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done, inflight = inflight[:k], inflight[k:]
        trials = [completed(p, objective(p), space) for p in done]
        history += trials
        port.observe(trials)
        ref.observe([completed(p, objective(p), ref_space, RefTrial) for p in done])
        assert port.state_dict() == ref.state_dict(), step
        assert port.rung_table == ref.rung_table, step
    return history


@pytest.mark.parametrize("config", [
    {"population_size": 10, "seed": 0, "mutation_factor": 0.5, "crossover_prob": 0.5},
    {"population_size": 4, "seed": 3, "reduction_factor": 2},
    {"population_size": 6, "seed": 8, "mutation_factor": 0.9, "crossover_prob": 0.9},
], ids=["dehb.yaml", "eta-2", "aggressive"])
def test_port_matches_reference_exactly(config):
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    port = make_algorithm(space, {"dehb": dict(config)})
    ref = ref_make_algorithm(ref_space, {"dehb": dict(config)})
    assert port.configuration == ref.configuration
    drive(port, ref, space, ref_space, 70, seed=5)
    assert port.rung_table[-1]["n"] > 0  # something reached the top rung


def test_replay_and_state_round_trip_continue_the_reference_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"dehb": {"population_size": 5, "seed": 4}}
    live = make_algorithm(space, dict(cfg))
    ref_live = ref_make_algorithm(ref_space, dict(cfg))
    history = drive(live, ref_live, space, ref_space, 20, seed=1)
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    port.observe(history)
    ref.observe([completed(t.params, t.objective, ref_space, RefTrial) for t in history])
    assert port.state_dict() == ref.state_dict()
    drive(port, ref, space, ref_space, 15, seed=2)
    again = make_algorithm(space, dict(cfg))
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    again.rng.bit_generator.state = port.rng.bit_generator.state
    drive(again, ref, space, ref_space, 15, seed=3)


class TestDEHB:
    def test_registered_and_validated(self):
        space = build_space(SPEC)
        assert isinstance(make_algorithm(space, {"dehb": {"population_size": 6}}), DEHB)
        with pytest.raises(ValueError):
            DEHB(space, population_size=3)
        with pytest.raises(ValueError):
            DEHB(space, reduction_factor=1)
        with pytest.raises(ValueError, match="fidelity"):
            DEHB(build_space({"x": "uniform(0, 1)"}))

    def test_bootstrap_respects_population_size(self):
        space = build_space(SPEC)
        algo = DEHB(space, seed=7, population_size=5)
        pts = algo.suggest(20)
        assert len(pts) == 5 and all(p["epochs"] == 1 and p in space for p in pts)
        assert algo.suggest(1) == []

    def test_promotion_top_1_over_eta(self):
        space = build_space(SPEC)
        algo = DEHB(space, seed=3, population_size=6, reduction_factor=3)
        pts = algo.suggest(6)
        objs = [0.1, 0.5, 0.2, 0.9, 0.3, 0.7]
        algo.observe([completed(p, o, space, tid=f"t{i}")
                      for i, (p, o) in enumerate(zip(pts, objs))])
        nxt = algo.suggest(6)
        promos = [p for p in nxt if p["epochs"] == 3]
        assert [p["epochs"] for p in nxt][:2] == [3, 3] and len(promos) == 2
        best = sorted(zip(objs, range(6)))[:2]
        assert sorted(p["lr"] for p in promos) == sorted(pts[i]["lr"] for _, i in best)

    def test_replay_reconstructs_without_duplicates(self):
        space = build_space(SPEC)
        algo = DEHB(space, seed=5, population_size=4)
        pts = algo.suggest(4)
        trials = [completed(p, float(i), space, tid=f"t{i}") for i, p in enumerate(pts)]
        replay = DEHB(space, seed=5, population_size=4)
        replay.observe(trials)
        seen = {space.hash_point(p) for p in pts}
        got = {space.hash_point(p) for p in replay.suggest(10) if p["epochs"] == 1}
        assert not (seen & got)
