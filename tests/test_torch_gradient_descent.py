"""The port's GradientDescent and the Trial's typed-result accessors.

GradientDescent is numpy: for the same seed and the same stream of
gradient-reporting trials its suggestions and state dicts equal the
reference's at every step. The accessors it reads (``objectives``,
``constraints``, ``gradient``, ``statistics``; MOTPE reads
``objectives``) return what the reference's return for the same results.
The reference's end-to-end contract (``tests/unit/test_worker.py::
test_gradient_descent_protocol_end_to_end``) is restated on the port.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import GradientDescent, make_algorithm
from metaopt_tpu_torch.executor import InProcessExecutor
from metaopt_tpu_torch.ledger import Experiment, MemoryLedger, Trial
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.worker import workon

SPEC = {"x": "uniform(-5, 5)", "y": "uniform(-2, 3)"}
CENTER = np.array([1.0, -0.5])


def results(params):
    v = np.array([params["x"], params["y"]])
    return [
        {"name": "f", "type": "objective", "value": float(np.sum((v - CENTER) ** 2))},
        {"name": "df", "type": "gradient", "value": (2 * (v - CENTER)).tolist()},
        {"name": "c", "type": "constraint", "value": float(v[0] - v[1])},
        {"name": "s", "type": "statistic", "value": 7.0},
    ]


def completed(params, trial_cls):
    t = trial_cls(params=params, experiment="e")
    t.transition("reserved")
    t.attach_results(results(params))
    t.transition("completed")
    return t


@pytest.mark.parametrize("cfg", [{"seed": 4, "learning_rate": 0.2},
                                 {"seed": 0, "learning_rate": 0.45}])
def test_port_matches_reference_exactly(cfg):
    port = make_algorithm(build_space(SPEC), {"gradient_descent": dict(cfg)})
    ref = ref_make_algorithm(ref_build_space(SPEC), {"gradientdescent": dict(cfg)})
    assert port.configuration == ref.configuration
    for step in range(25):
        got, want = port.suggest(1), ref.suggest(1)
        assert got == want, step
        port.observe([completed(got[0], Trial)])
        ref.observe([completed(want[0], RefTrial)])
        assert port.state_dict() == ref.state_dict(), step
        assert port.is_done == ref.is_done
    again = make_algorithm(build_space(SPEC), {"gradient_descent": dict(cfg)})
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    assert again.suggest(1) == ref.suggest(1)


def test_registered_under_both_names_and_real_only():
    space = build_space(SPEC)
    assert isinstance(make_algorithm(space, {"gradientdescent": {}}), GradientDescent)
    assert isinstance(make_algorithm(space, {"gradient_descent": {}}), GradientDescent)
    with pytest.raises(ValueError, match="Real dimensions only"):
        GradientDescent(build_space({"c": "choices(['a', 'b'])"}))


def test_trial_accessors_equal_the_reference():
    params = {"x": 0.5, "y": 2.0}
    port, ref = completed(params, Trial), completed(params, RefTrial)
    port.attach_results([{"name": "f2", "type": "objective", "value": 3.5}])
    ref.attach_results([{"name": "f2", "type": "objective", "value": 3.5}])
    assert port.objectives == ref.objectives == [port.objective, 3.5]
    assert port.gradient.value == ref.gradient.value == [-1.0, 5.0]
    for name in ("constraints", "statistics"):
        assert ([r.to_dict() for r in getattr(port, name)]
                == [r.to_dict() for r in getattr(ref, name)])
    assert Trial(params=params).gradient is None and Trial(params=params).objectives == []


def test_gradient_descent_protocol_end_to_end():
    space = build_space({"x": "uniform(-5, 5)"})
    exp = Experiment(
        "g", MemoryLedger(), space=space, max_trials=12,
        algorithm={"gradient_descent": {"learning_rate": 0.2, "seed": 4}},
    ).configure()

    def objective(p):
        x = p["x"]
        return [
            {"name": "f", "type": "objective", "value": (x - 1.0) ** 2},
            {"name": "df", "type": "gradient", "value": [2 * (x - 1.0)]},
        ]

    workon(exp, InProcessExecutor(objective), "w0")
    best = exp.stats["best"]
    assert best["objective"] < 0.05
    assert abs(best["params"]["x"] - 1.0) < 0.25
