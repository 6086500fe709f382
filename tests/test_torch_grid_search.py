"""The port's GridSearch against the reference's.

GridSearch is deterministic numpy, so the two must agree exactly: the
same space and config give identical suggestion streams and state dicts at
every step, and a restored state continues the reference's stream. The
reference's ``tests/unit/test_grid_search.py`` contracts are restated
against the port.
"""

import json

import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import GridSearch, make_algorithm
from metaopt_tpu_torch.executor import InProcessExecutor
from metaopt_tpu_torch.ledger import Experiment, MemoryLedger
from metaopt_tpu_torch.space import build_space
from metaopt_tpu_torch.worker import workon

SPACES = {
    "mixed": {"x": "uniform(0, 10)", "lr": "loguniform(1e-4, 1e-1)",
              "n": "uniform(1, 3, discrete=True)", "c": "choices(['a', 'b', 'c'])"},
    "fidelity": {"x": "uniform(-5, 5)", "epochs": "fidelity(1, 8, base=2)"},
    "rosenbrock": {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)"},
}


@pytest.mark.parametrize("name", sorted(SPACES))
@pytest.mark.parametrize("n_values", [2, 5])
def test_port_matches_reference_exactly(name, n_values):
    cfg = {"grid_search": {"n_values": n_values, "seed": 3}}
    port = make_algorithm(build_space(SPACES[name]), cfg)
    ref = ref_make_algorithm(ref_build_space(SPACES[name]), cfg)
    assert port.configuration == ref.configuration
    rng = np.random.default_rng(0)
    while not ref.is_done:
        num = int(rng.integers(1, 6))
        assert port.suggest(num) == ref.suggest(num)
        assert port.state_dict() == ref.state_dict()
        assert port.is_done == ref.is_done
    assert port.is_done and port.suggest(2) == [] == ref.suggest(2)


def test_state_dict_round_trip_continues_the_reference_stream():
    cfg = {"grid_search": {"n_values": 4}}
    port = make_algorithm(build_space(SPACES["mixed"]), cfg)
    ref = ref_make_algorithm(ref_build_space(SPACES["mixed"]), cfg)
    port.suggest(7)
    ref.suggest(7)
    again = make_algorithm(build_space(SPACES["mixed"]), cfg)
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    assert again.suggest(20) == ref.suggest(20)


class TestGrid:
    def test_covers_full_lattice_once(self):
        space = build_space({"x": "uniform(0, 10)", "c": "choices(['a', 'b', 'c'])"})
        gs = GridSearch(space, n_values=4)
        pts = gs.suggest(100)
        assert len(pts) == 4 * 3
        assert len({tuple(sorted(p.items())) for p in pts}) == 12
        assert all(p in space for p in pts)
        assert gs.is_done
        assert gs.suggest(1) == []

    def test_loguniform_grid_is_log_spaced(self):
        gs = GridSearch(build_space({"lr": "loguniform(1e-4, 1e-1)"}), n_values=4)
        xs = sorted(p["lr"] for p in gs.suggest(10))
        ratios = [xs[i + 1] / xs[i] for i in range(len(xs) - 1)]
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-6)

    def test_integer_dim_capped_at_cardinality(self):
        gs = GridSearch(build_space({"n": "uniform(1, 3, discrete=True)"}), n_values=10)
        assert sorted(p["n"] for p in gs.suggest(50)) == [1, 2, 3]

    def test_fidelity_pinned_to_max(self):
        gs = GridSearch(build_space(SPACES["fidelity"]), n_values=3)
        assert all(p["epochs"] == 8 for p in gs.suggest(5))

    def test_exhausted_grid_drains_queued_trials(self):
        exp = Experiment(
            "grid-drain", MemoryLedger(),
            space=build_space({"x": "uniform(0, 6)", "c": "choices(['a', 'b'])"}),
            max_trials=20, pool_size=5, algorithm={"grid_search": {"n_values": 6}},
        ).configure()
        stats = workon(exp, InProcessExecutor(
            lambda p: (p["x"] - 3) ** 2 + {"a": 0.0, "b": 1.0}[p["c"]]))
        assert stats.completed == 12  # the full 6×2 lattice ran
        assert exp.is_done
        best = min(t.objective for t in exp.fetch_trials("completed"))
        assert abs(best - 0.25) < 1e-9

    def test_huge_grid_is_lazy(self):
        gs = GridSearch(build_space({f"x{i}": "uniform(0, 1)" for i in range(8)}),
                        n_values=50)
        assert gs._total == 50 ** 8
        pts = gs.suggest(3)
        assert len(pts) == 3 and not gs.is_done
