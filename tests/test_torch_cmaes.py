"""The port's CMA-ES against the reference's.

CMA-ES is host numpy (per-generation RNGs seeded by (ctor seed,
generation)), so the two must agree exactly: the same seed and stream of
completed trials give identical suggestions and state dicts at every
step, across generations, with ``max_generations``, after a restart that
replays the ledger, and across ``state_dict`` round trips. The
suggest-ahead thread advances generations off the suggest path; the
state is compared after each suggest, once the thread is joined, which is
where it no longer depends on whether the thread or the caller ran the
generation math. The reference's ``tests/unit/test_cmaes.py`` contracts
are restated against the port.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import CMAES, make_algorithm
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.models.objectives import rosenbrock
from metaopt_tpu_torch.space import build_space

SPEC = {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)"}
MIXED = {"lr": "loguniform(1e-4, 1e-1)", "n": "uniform(1, 8, discrete=True)",
         "opt": "choices(['a', 'b', 'c'])", "m": "uniform(0, 1)"}


def completed(params, objective, space, trial_cls=Trial):
    t = trial_cls(params=params, experiment="e")
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


def objective(p):
    if "x" in p:
        return rosenbrock(p)
    return ((np.log10(p["lr"]) + 2) ** 2 + (p["n"] - 3) ** 2 / 10
            + {"a": 0.0, "b": 0.5, "c": 1.0}[p["opt"]] + p["m"])


def drive(port, ref, space, ref_space, steps, seed):
    """Random asks and out-of-order completions; compare every step."""
    rng = np.random.default_rng(seed)
    inflight, history = [], []
    for step in range(steps):
        num = int(rng.integers(1, 6))
        got, want = port.suggest(num), ref.suggest(num)
        assert got == want, step
        port.drain_suggest_ahead()
        ref.drain_suggest_ahead()
        assert port.state_dict() == ref.state_dict(), step
        assert port.generation == ref.generation and port.is_done == ref.is_done
        inflight += got
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done, inflight = inflight[:k], inflight[k:]
        trials = [completed(p, objective(p), space) for p in done]
        history += trials
        port.observe(trials)
        ref.observe([completed(p, objective(p), ref_space, RefTrial) for p in done])
    return history


@pytest.mark.parametrize("spec,config", [
    (SPEC, {"seed": 0, "population_size": 8}),
    (SPEC, {"seed": 3}),
    (MIXED, {"seed": 5, "population_size": 6, "sigma0": 0.5}),
    (MIXED, {"seed": 7, "population_size": 4, "max_generations": 3}),
], ids=["cmaes.yaml", "default-lambda", "mixed-space", "max-generations"])
def test_port_matches_reference_exactly(spec, config):
    space, ref_space = build_space(spec), ref_build_space(spec)
    port = make_algorithm(space, {"cmaes": dict(config)})
    ref = ref_make_algorithm(ref_space, {"cmaes": dict(config)})
    assert port.configuration == ref.configuration
    assert port.cohort_size == ref.cohort_size
    drive(port, ref, space, ref_space, 60, seed=1)
    assert port.generation >= 3
    if "max_generations" in config:
        assert port.is_done and port.suggest(2) == [] == ref.suggest(2)


def test_replay_after_restart_continues_the_reference_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"cma": {"seed": 11, "population_size": 5}}
    live = make_algorithm(space, dict(cfg))
    ref_live = ref_make_algorithm(ref_space, dict(cfg))
    history = drive(live, ref_live, space, ref_space, 20, seed=4)
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    port.observe(history)
    ref.observe([completed(t.params, t.objective, ref_space, RefTrial) for t in history])
    drive(port, ref, space, ref_space, 30, seed=6)


def test_state_dict_round_trip_continues_the_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"cmaes": {"seed": 9, "population_size": 6}}
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    drive(port, ref, space, ref_space, 15, seed=2)
    again = make_algorithm(space, dict(cfg))
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    drive(again, ref, space, ref_space, 20, seed=3)


class TestCMAES:
    def test_generation_barrier(self):
        space = build_space(SPEC)
        algo = CMAES(space, seed=0, population_size=6)
        pts = algo.suggest(100)
        assert len(pts) == 6 and algo.suggest(1) == []
        for i, p in enumerate(pts):
            algo.observe([completed(p, float(i), space)])
        assert len(algo.suggest(6)) == 6

    def test_converges_on_quadratic(self):
        space = build_space({"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"})
        algo = CMAES(space, seed=3, population_size=8)
        best = np.inf
        for _ in range(15):
            pts = algo.suggest(8)
            if not pts:
                break
            objs = [(p["x"] - 1.0) ** 2 + (p["y"] + 2.0) ** 2 for p in pts]
            best = min(best, *objs)
            algo.observe([completed(p, o, space) for p, o in zip(pts, objs)])
        assert best < 0.1
        assert algo._sigma < algo.sigma0

    def test_rebuilt_instance_issues_identical_generation(self):
        space = build_space(SPEC)
        assert (CMAES(space, seed=7, population_size=5).suggest(5)
                == CMAES(space, seed=7, population_size=5).suggest(5))

    def test_replay_fast_forwards_in_one_call(self):
        space = build_space(SPEC)
        a = CMAES(space, seed=11, population_size=4)
        all_trials = []
        for g in range(3):
            pts = a.suggest(4)
            trials = [completed(p, float(i + 10 * g), space) for i, p in enumerate(pts)]
            a.observe(trials)
            all_trials += trials
        b = CMAES(space, seed=11, population_size=4)
        b.observe(all_trials)
        fresh = b.suggest(4)
        assert len(fresh) >= 3 and b.generation == 3
        assert fresh == a.suggest(4) and a.generation == 3

    def test_suggest_ahead_serves_the_next_generation(self):
        space = build_space(SPEC)
        algo = CMAES(space, seed=2, population_size=4)
        pts = algo.suggest(4)
        algo.observe([completed(p, float(i), space) for i, p in enumerate(pts)])
        algo.drain_suggest_ahead()
        assert algo.generation == 1  # advanced off the suggest path
        assert len(algo.suggest(4)) == 4
        assert algo.telemetry()["prefetch_hits"] >= 1
