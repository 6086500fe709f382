"""The port's EvolutionES against the reference's.

EvolutionES draws with numpy only, so the two must agree exactly: the same
seed, space and stream of completed trials give identical suggestions,
generations and state dicts at every step, over several generations, with
a categorical dimension, with ``max_generations``, after a restart that
replays the ledger into a fresh instance, and across ``state_dict``
round trips. The reference's ``TestEvolutionES`` contracts
(``tests/unit/test_algos.py``) are restated against the port.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import EvolutionES, make_algorithm
from metaopt_tpu_torch.algo.base import BaseAlgorithm
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space

SPEC = {"x": "uniform(-5, 5)", "lr": "loguniform(1e-4, 1e-1)",
        "opt": "choices(['a', 'b', 'c'])", "epochs": "fidelity(2, 16, base=2)"}


def completed(params, objective, space, trial_cls=Trial):
    t = trial_cls(params=params, experiment="e")
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


def objective(p):
    return ((p["x"] - 1.0) ** 2 + np.log10(p["lr"]) ** 2 / 10
            + {"a": 0.0, "b": 0.5, "c": 1.0}[p["opt"]] - np.log2(p["epochs"]) / 4)


def drive(port, ref, space, ref_space, steps, seed, check=True):
    """Suggest a random number of points from both, complete a random
    subset of the in-flight ones in random order, and compare after every
    step; returns the port's completed trials and the budgets issued."""
    rng = np.random.default_rng(seed)  # drives the stream, not the algorithms
    inflight, history, budgets = [], [], []
    for step in range(steps):
        num = int(rng.integers(1, 5))
        got, want = port.suggest(num), ref.suggest(num)
        assert got == want, step
        inflight += got
        budgets += [p["epochs"] for p in got]
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done, inflight = inflight[:k], inflight[k:]
        trials = [completed(p, objective(p), space) for p in done]
        history += trials
        port.observe(trials)
        ref.observe([completed(p, objective(p), ref_space, RefTrial) for p in done])
        if check:
            assert port.state_dict() == ref.state_dict(), step
            assert port.generation == ref.generation and port.is_done == ref.is_done, step
    return history, budgets


@pytest.mark.parametrize("config", [
    {"seed": 0, "population_size": 10},
    {"seed": 3, "population_size": 4, "mutate_prob": 0.9, "mutate_scale": 0.5},
    {"seed": 7, "population_size": 6, "max_generations": 3},
], ids=["evolution.yaml", "mutate-hard", "max-generations"])
def test_port_matches_reference_exactly(config):
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    port = make_algorithm(space, {"evolution_es": dict(config)})
    ref = ref_make_algorithm(ref_space, {"evolution_es": dict(config)})
    assert port.configuration == ref.configuration
    assert port.cohort_size == ref.cohort_size == config["population_size"]
    _, budgets = drive(port, ref, space, ref_space, 80, seed=11)
    assert port.generation >= 3
    assert {2, 4, 8} <= set(budgets)
    if "max_generations" in config:
        assert port.is_done and port.suggest(3) == [] == ref.suggest(3)


def test_stray_replay_after_restart_continues_the_reference_stream():
    # a worker restarts: a fresh instance (no state) replays the ledger's
    # completed trials, one and a half generations in, and carries on
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"evolution_es": {"seed": 5, "population_size": 6}}
    live = make_algorithm(space, dict(cfg))
    history = []
    while live.generation < 1 or len(history) < 9:
        for p in live.suggest(2):
            t = completed(p, objective(p), space)
            history.append(t)
            live.observe([t])
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    port.observe(history)
    ref.observe([completed(t.params, t.objective, ref_space, RefTrial) for t in history])
    assert port.state_dict() == ref.state_dict()
    drive(port, ref, space, ref_space, 40, seed=2)
    assert port.generation >= 2


def test_state_dict_round_trip_continues_the_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"evolution_es": {"seed": 9, "population_size": 4}}
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    drive(port, ref, space, ref_space, 15, seed=4)
    state = json.loads(json.dumps(port.state_dict()))  # what a snapshot stores
    again = make_algorithm(space, dict(cfg))
    again.load_state_dict(state)
    again.rng = np.random.default_rng()
    again.rng.bit_generator.state = port.rng.bit_generator.state
    assert again.state_dict() == port.state_dict()
    # the restored instance continues exactly where the reference does
    drive(again, ref, space, ref_space, 25, seed=8)


class TestEvolutionESContracts:
    def make_space(self):
        return build_space({"x": "uniform(-5, 5)", "opt": "choices(['a', 'b'])",
                            "epochs": "fidelity(1, 4, base=2)"})

    def test_generations_and_budget_ramp(self):
        space = self.make_space()
        algo = EvolutionES(space, seed=0, population_size=4, max_generations=3)
        gen0 = algo.suggest(10)
        assert len(gen0) == 4               # population barrier
        assert all(p["epochs"] == 1 for p in gen0)
        for i, p in enumerate(gen0):
            algo.observe([completed(p, i / 10, space)])
        gen1 = algo.suggest(10)
        assert len(gen1) == 4
        assert all(p["epochs"] == 2 for p in gen1)  # budget ramped up a rung
        assert algo.generation == 1
        assert all(p in space for p in gen1)

    def test_survivor_bias(self):
        space = build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 2, base=2)"})
        algo = EvolutionES(space, seed=1, population_size=6, mutate_prob=1.0,
                           mutate_scale=0.01)
        gen0 = algo.suggest(6)
        for p in gen0:
            algo.observe([completed(p, p["x"], space)])
        best3 = sorted(p["x"] for p in gen0)[:3]
        gen1 = algo.suggest(6)
        assert algo.generation == 1
        for p in gen1:
            assert min(abs(p["x"] - b) for b in best3) < 0.1

    def test_registered_under_both_names_and_needs_a_fidelity(self):
        space = self.make_space()
        for name in ("evolution_es", "evolutiones"):
            assert isinstance(make_algorithm(space, {name: {"seed": 0}}), EvolutionES)
        with pytest.raises(ValueError, match="population_size must be >= 2"):
            EvolutionES(space, population_size=1)
        with pytest.raises(ValueError) as err:
            make_algorithm(build_space({"x": "uniform(0, 1)"}), {"evolution_es": {}})
        with pytest.raises(ValueError) as ref_err:
            ref_make_algorithm(ref_build_space({"x": "uniform(0, 1)"}), {"evolution_es": {}})
        assert str(err.value) == str(ref_err.value)
        assert make_algorithm(space, {"random": {"seed": 0}}).cohort_size is None
        assert BaseAlgorithm.cohort_size.fget(EvolutionES(space)) is None
