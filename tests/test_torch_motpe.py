"""The port's MOTPE against the reference's.

The Pareto ordering is host numpy and must be exact: ranks, crowding
distances and pseudo-objective keys equal the reference's to the bit, on
random objective vectors with ties and duplicates. The random phase
equals the reference's for the same seed; past it, the port's TPE is fed
the reference's own threefry draws (``tpe_suggest_fused``'s ``draws``
seam) and picks the reference's winners on a ZDT1 stream
(``examples/motpe.yaml``'s settings). The reference's
``tests/unit/test_motpe.py`` contracts are restated against the port.
"""

import math

import jax
import numpy as np
import pytest

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.algo import motpe as R
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import MOTPE, make_algorithm
from metaopt_tpu_torch.algo import motpe as P
from metaopt_tpu_torch.algo import tpe as port_tpe
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ops import tpe_math
from metaopt_tpu_torch.space import build_space
from test_torch_tpe import reference_draws

ZDT1 = {"x": "uniform(0, 1)", "y": "uniform(0, 1)"}
MOTPE_YAML = {"seed": 0, "n_objectives": 2, "n_initial_points": 12, "gamma": 0.3}


def zdt1(p):
    g = 1.0 + 9.0 * p["y"]
    return [p["x"], g * (1.0 - math.sqrt(max(p["x"], 0.0) / g))]


def completed(space, params, objectives, trial_cls=Trial):
    t = trial_cls(params=params, experiment="e")
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": f"o{i}", "type": "objective", "value": v}
                      for i, v in enumerate(objectives)])
    t.transition("completed")
    return t


def make_motpe(seed=0, **kw):
    space = build_space({"x": "uniform(0, 4)"})
    return space, MOTPE(space, seed=seed, n_initial_points=5, device="cpu", **kw)


@pytest.mark.parametrize("n,m,levels", [(40, 2, 5), (60, 3, 4), (25, 2, 0), (3, 2, 2)])
def test_pareto_ordering_is_exact(n, m, levels):
    rng = np.random.default_rng(n * m)
    # integer levels make ties and duplicate vectors common
    F = (rng.integers(0, levels, (n, m)).astype(float) if levels else rng.random((n, m)))
    np.testing.assert_array_equal(P.nondominated_ranks(F), R.nondominated_ranks(F))
    for r in range(int(R.nondominated_ranks(F).max()) + 1):
        front = F[R.nondominated_ranks(F) == r]
        np.testing.assert_array_equal(P.crowding_distance(front), R.crowding_distance(front))
    np.testing.assert_array_equal(P.pareto_order_keys(F), R.pareto_order_keys(F))


@pytest.fixture
def reference_draws_in_port(monkeypatch):
    """The port's TPE launches with the reference's threefry draws, keyed by
    the fit key the reference derives from (kernel seed, observation count)."""
    seeds, launches = {}, []
    plain = port_tpe.tpe_suggest_fused

    def with_ref_draws(X, y, n, count, fit_seed, *args, n_cand, n_out, n_pools=1, **kw):
        ks, n_obs = seeds[fit_seed]
        fit_key = jax.random.fold_in(jax.random.PRNGKey(ks), n_obs)
        launches.append(n)
        draws = reference_draws(fit_key, count, n_pools, n_out * n_cand, X.shape[1])
        return plain(X, y, n, count, fit_seed, *args, n_cand=n_cand, n_out=n_out,
                     n_pools=n_pools, draws=draws, **kw)

    def register(algo):
        seeds.update({tpe_math.stream_seed(algo._kernel_seed, k): (algo._kernel_seed, k)
                      for k in range(256)})

    monkeypatch.setattr(port_tpe, "tpe_suggest_fused", with_ref_draws)
    return register, launches


def test_zdt1_stream_picks_the_reference_winners(reference_draws_in_port):
    register, launches = reference_draws_in_port
    space, ref_space = build_space(ZDT1), ref_build_space(ZDT1)
    port = make_algorithm(space, {"motpe": {**MOTPE_YAML, "device": "cpu"}})
    ref = ref_make_algorithm(ref_space, {"motpe": dict(MOTPE_YAML)})
    assert port.configuration == ref.configuration
    register(port)
    for step in range(24):
        [got], [want] = port.suggest(1), ref.suggest(1)
        if step < MOTPE_YAML["n_initial_points"]:
            assert got == want, step
        else:
            np.testing.assert_allclose([got["x"], got["y"]], [want["x"], want["y"]],
                                       rtol=1e-6, atol=1e-6, err_msg=str(step))
        port.observe([completed(space, got, zdt1(got))])
        ref.observe([completed(ref_space, want, zdt1(want), RefTrial)])
        port.drain_suggest_ahead()
        ref.drain_suggest_ahead()
        np.testing.assert_allclose(port._y, ref._y, rtol=0, atol=1e-6)
    assert len(launches) >= 6
    assert len(port.pareto_front()) == len(ref.pareto_front())


class TestAlgorithm:
    def test_nondominated_ranks_hand_case(self):
        F = np.array([[0.0, 3.0], [1.0, 1.0], [3.0, 0.0], [2.0, 2.0], [4.0, 4.0]])
        assert P.nondominated_ranks(F).tolist() == [0, 0, 0, 1, 2]
        assert P.nondominated_ranks(np.array([[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]])
                                    ).tolist() == [0, 0, 1]

    def test_config_rejects_single_objective(self):
        with pytest.raises(ValueError, match="n_objectives"):
            MOTPE(build_space({"x": "uniform(0, 4)"}), n_objectives=1, device="cpu")

    def test_split_selects_nondominated_first(self):
        space, mo = make_motpe(gamma=0.25)
        pts = [(0.5, [5.0, 5.0]), (1.0, [6.0, 6.0]), (1.5, [5.5, 7.0]),
               (2.0, [7.0, 5.5]), (2.5, [8.0, 8.0]), (3.0, [9.0, 4.9]),
               (3.5, [1.0, 2.0]), (0.1, [2.0, 1.0])]
        for x, f in pts:
            mo.observe([completed(space, {"x": x}, f)])
        below, _ = mo._split()
        assert sorted(below.tolist()) == [6, 7]

    def test_short_and_nan_vectors_excluded_from_fit(self):
        space, mo = make_motpe()
        mo.observe([completed(space, {"x": 1.0}, [1.0]),
                    completed(space, {"x": 1.5}, [float("nan"), 0.1]),
                    completed(space, {"x": 2.0}, [1.0, 2.0])])
        assert mo.n_observed == 3 and mo._F == [[1.0, 2.0]]
        assert len(mo.pareto_front()) == 1

    def test_state_roundtrip_rebuilds_keys(self):
        space, mo = make_motpe(seed=5)
        for x, f in [(1.0, [1.0, 3.0]), (2.0, [3.0, 1.0]), (3.0, [4.0, 4.0])]:
            mo.observe([completed(space, {"x": x}, f)])
        state = mo.state_dict()
        state["y"] = [99.0] * len(state["y"])
        fresh = MOTPE(space, seed=5, device="cpu")
        fresh.load_state_dict(state)
        assert fresh._F == mo._F and np.allclose(fresh._y, mo._y)
        assert sorted(f for _, f in fresh.pareto_front()) == [[1.0, 3.0], [3.0, 1.0]]

    def test_suggest_in_space_and_converges_toward_front(self):
        space, mo = make_motpe(seed=3, gamma=0.3)
        rng = np.random.default_rng(11)
        for _ in range(40):
            x = float(rng.uniform(0, 4))
            mo.observe([completed(space, {"x": x}, [x * x, (x - 2.0) ** 2])])
        xs = np.array([p["x"] for p in mo.suggest(16)])
        assert np.mean((xs > -0.5) & (xs < 2.5)) >= 0.75

    def test_rebuild_keys_refreshes_device_mirror(self):
        space, mo = make_motpe(seed=2)
        mo._suggest_ahead_async = lambda: None
        mo.observe([completed(space, {"x": 1.0}, [1.0, 3.0]),
                    completed(space, {"x": 2.0}, [3.0, 1.0])])
        mo._buf.sync(mo._X, mo._y)
        mo.observe([completed(space, {"x": 0.5}, [0.5, 0.5])])  # dominates both
        mo._buf.sync(mo._X, mo._y)
        dev = mo._buf.ydev.numpy()[: len(mo._y)]
        np.testing.assert_allclose(dev, np.asarray(mo._y, np.float32), rtol=1e-6)
        assert dev[0] >= 1.0 and dev[1] >= 1.0

    def test_make_algorithm_builds_motpe_without_device_in_its_configuration(self):
        algo = make_algorithm(build_space({"x": "uniform(0, 4)"}),
                              {"motpe": {"n_objectives": 2, "seed": 1, "device": "cpu"}})
        assert isinstance(algo, MOTPE)
        assert algo.configuration["motpe"]["n_objectives"] == 2
        assert "device" not in algo.configuration["motpe"]
