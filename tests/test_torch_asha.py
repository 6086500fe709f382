"""The port's ASHA against the reference's.

ASHA draws with numpy only, so the two must agree exactly: the same seed,
space and stream of completed trials give identical suggestions, rung
tables and state dicts at every step. The reference's ``TestASHA``
contracts (``tests/unit/test_algos.py``) are restated against the port,
and ``requires_fidelity`` raises the reference's ``ValueError``.
"""

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import ASHA, make_algorithm
from metaopt_tpu_torch.algo.base import BaseAlgorithm
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.space import build_space


def make_space(fidelity=False, build=build_space):
    spec = {"x": "uniform(-5, 5)", "opt": "choices(['a', 'b'])"}
    if fidelity:
        spec["epochs"] = "fidelity(1, 4, base=2)"
    return build(spec)


def completed(params, objective, space, trial_cls=Trial):
    t = trial_cls(params=params, experiment="e")
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


class TestASHAContracts:
    def test_promotion_rule_hand_computed(self):
        space = make_space(fidelity=True)  # rungs [1, 2, 4], eta=2
        algo = ASHA(space, seed=0)
        pts = algo.suggest(4)
        assert all(p["epochs"] == 1 for p in pts)  # all enter bottom rung
        for i, p in enumerate(pts):
            algo.observe([completed(p, (i + 1) / 10, space)])
        # 4 results at rung 0, eta=2 → top-2 promotable; best first
        nxt = algo.suggest(1)[0]
        assert nxt["epochs"] == 2 and nxt["x"] == pts[0]["x"]
        nxt2 = algo.suggest(1)[0]
        assert nxt2["epochs"] == 2 and nxt2["x"] == pts[1]["x"]
        # no third promotion: next suggestion is a fresh bottom-rung point
        assert algo.suggest(1)[0]["epochs"] == 1

    def test_promotion_to_top_rung(self):
        space = make_space(fidelity=True)
        algo = ASHA(space, seed=0)
        pts = algo.suggest(4)
        for i, p in enumerate(pts):
            algo.observe([completed(p, i / 10, space)])
        promo0 = algo.suggest(1)[0]
        assert promo0["epochs"] == 2 and promo0["x"] == pts[0]["x"]
        algo.observe([completed(promo0, 0.05, space)])
        # rung1 has 1 result → 1//2 == 0 → next promotion still from rung0
        promo1 = algo.suggest(1)[0]
        assert promo1["epochs"] == 2 and promo1["x"] == pts[1]["x"]
        algo.observe([completed(promo1, 0.06, space)])
        # rung1 now has 2 results → k=1 → best (pts[0] lineage) → budget 4
        top = algo.suggest(1)[0]
        assert top["epochs"] == 4 and top["x"] == pts[0]["x"]

    def test_rung_table_and_state_roundtrip(self):
        space = make_space(fidelity=True)
        algo = ASHA(space, seed=0)
        for p in algo.suggest(2):
            algo.observe([completed(p, 0.1, space)])
        algo2 = ASHA(space, seed=0)
        algo2.load_state_dict(algo.state_dict())
        assert algo2.rung_table == algo.rung_table
        assert algo2.state_dict() == algo.state_dict()

    def test_registered_and_configured(self):
        algo = make_algorithm(make_space(fidelity=True), {"asha": {"seed": 3}})
        assert isinstance(algo, ASHA) and algo.eta == 2
        assert algo.configuration == {"asha": {"seed": 3, "num_rungs": None, "num_brackets": 1,
                                               "reduction_factor": None}}

    def test_bad_reduction_factor_and_brackets_raise(self):
        with pytest.raises(ValueError, match="reduction_factor must be >= 2"):
            ASHA(make_space(fidelity=True), reduction_factor=1)
        with pytest.raises(ValueError, match="num_brackets=4 exceeds 3 rungs"):
            ASHA(make_space(fidelity=True), num_brackets=4)


@pytest.mark.parametrize("config", [
    {"seed": 0},
    {"seed": 7, "num_brackets": 2},
    {"seed": 1, "reduction_factor": 3, "num_rungs": 2},
])
def test_port_matches_reference_exactly(config):
    spec = {"x": "uniform(-5, 5)", "lr": "loguniform(1e-4, 1e-1)",
            "opt": "choices(['a', 'b', 'c'])", "epochs": "fidelity(1, 16, base=2)"}
    ref_space, space = ref_build_space(spec), build_space(spec)
    ref = ref_make_algorithm(ref_space, {"asha": dict(config)})
    port = make_algorithm(space, {"asha": dict(config)})
    assert port.configuration == ref.configuration
    rng = np.random.default_rng(11)  # drives the stream, not the algorithms

    def objective(p):
        return (p["x"] - 1.0) ** 2 + np.log(p["lr"]) ** 2 / 10 + {"a": 0, "b": 0.5, "c": 1}[
            p["opt"]] - np.log2(p["epochs"]) / 4

    inflight = []
    budgets = set()
    for step in range(120):
        num = int(rng.integers(1, 4))
        got, want = port.suggest(num), ref.suggest(num)
        assert got == want, step
        inflight += got
        budgets |= {p["epochs"] for p in got}
        # complete a random subset of the in-flight points, in random order
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done, inflight = inflight[:k], inflight[k:]
        port.observe([completed(p, objective(p), space) for p in done])
        ref.observe([completed(p, objective(p), ref_space, RefTrial) for p in done])
        assert port.rung_table == ref.rung_table, step
        assert port.state_dict() == ref.state_dict(), step
    assert budgets == {r["budget"] for r in port.rung_table}  # every rung was reached


def test_requires_fidelity_raises_like_the_reference():
    with pytest.raises(ValueError) as ref_err:
        ref_make_algorithm(make_space(build=ref_build_space), {"asha": {}})
    with pytest.raises(ValueError) as err:
        make_algorithm(make_space(), {"asha": {}})
    assert str(err.value) == str(ref_err.value)
    assert "needs a fidelity dimension" in str(err.value)
    assert ASHA.requires_fidelity and not BaseAlgorithm.requires_fidelity
    # the other ported algorithms take a space with or without fidelity
    assert make_algorithm(make_space(), {"random": {"seed": 0}}).suggest(1)


def test_status_rung_table_is_a_replay_of_the_ledger():
    # what `status --rungs` shows: a fresh algorithm fed the completed
    # trials — their counts per rung; promotions live only in the algorithm
    # that suggested them, so the replay shows none (as the reference's)
    space = make_space(fidelity=True)
    algo = ASHA(space, seed=0)
    history = []
    for i in range(10):
        for p in algo.suggest(1):
            t = completed(p, float(i % 3), space)
            history.append(t)
            algo.observe([t])
    replay = ASHA(space, seed=0)
    replay.observe(history)
    assert [r["n"] for r in replay.rung_table] == [r["n"] for r in algo.rung_table]
    assert [r["n"] for r in replay.rung_table][-1] >= 1
    assert all(r["promoted"] == 0 for r in replay.rung_table)
    assert sum(r["promoted"] for r in algo.rung_table) >= 2
