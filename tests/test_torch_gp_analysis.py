"""GP-BO's surrogate analyses, the port against the reference, on the CPU.

``ard_importance`` and ``partial_dependence`` take the same numpy inputs
(made from a seed, with a NaN and an inf objective among them) through
both packages at n ∈ {12, 24, 40} and d ∈ {2, 5}; importance and the
de-standardized curves agree within 1e-4, GP-BO's fit bound (measured
1.5e-5 and 1.9e-5 at worst over these inputs: the fit's 80 Adam steps
carry the gradient's f32 rounding). The host steps are the reference's
numpy code, so the background draw and the grid are bit-equal; the
queries each package hands its posterior mean are compared to show it.
The reference's ``TestImportance`` and ``TestPartialDependence``
contracts (``tests/unit/test_gp_bo.py``) are restated against the port,
and the analyses never fall back to the CPU on their own.
"""

import json

import numpy as np
import pytest
import torch

from metaopt_tpu.algo import gp_bo as R
from metaopt_tpu_torch.algo import gp_bo as P

TOL = 1e-4


def inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    w = rng.random(d)
    y = ((X - 0.3) ** 2 @ w * 5 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y[1], y[3] = np.nan, np.inf
    return X, y


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("n", [12, 24, 40])
def test_importance_and_pdp_match_the_reference(n, d):
    X, y = inputs(n, d, 10 * n + d)
    want = R.ard_importance(X, y)
    got = P.ard_importance(X, y, device="cpu")
    assert got.dtype == np.float64 and got.shape == (d,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    g_ref, c_ref = R.partial_dependence(X, y)
    g, c = P.partial_dependence(X, y, device="cpu")
    assert g.dtype == np.float32 and np.array_equal(g, g_ref)
    assert c.dtype == np.float64 and c.shape == (d, 24)
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=TOL)


def test_background_draw_and_queries_are_bit_equal(monkeypatch):
    """n above ``max_background``: both packages draw the same background
    rows from ``np.random.RandomState(seed)`` and pin the same grid."""
    X, y = inputs(80, 3, 7)
    seen = {"ref": [], "port": []}
    ref_mean, port_mean = R._mean_from_alpha, P._mean_from_alpha

    def ref_spy(Xp, mask, params, alpha, Q):
        seen["ref"].append(np.asarray(Q))
        return ref_mean(Xp, mask, params, alpha, Q)

    def port_spy(Xp, mask, params, alpha, Q):
        seen["port"].append(Q.numpy().copy())
        return port_mean(Xp, mask, params, alpha, Q)

    monkeypatch.setattr(R, "_mean_from_alpha", ref_spy)
    monkeypatch.setattr(P, "_mean_from_alpha", port_spy)
    g_ref, c_ref = R.partial_dependence(X, y, n_grid=8, max_background=16, seed=5)
    g, c = P.partial_dependence(X, y, n_grid=8, max_background=16, seed=5, device="cpu")
    assert np.array_equal(g, g_ref)
    assert len(seen["port"]) == len(seen["ref"]) == 3
    for a, b in zip(seen["port"], seen["ref"]):
        assert a.shape == (8 * 16, 3) and np.array_equal(a, b)
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=TOL)


def test_padded_inputs_and_fit_equal_the_reference():
    """The host preamble pads and standardizes bit for bit; the fitted
    hyperparameters agree within the fit bound."""
    X, y = inputs(24, 2, 3)
    rp, rX, ry, rmask, rmu, rsd, rXf = R._fit_surrogate(X, y)
    pp, pX, py, pmask, pmu, psd, pXf = P._fit_surrogate(X, y, device="cpu")
    assert (pmu, psd) == (rmu, rsd) and np.array_equal(pXf, rXf)
    for a, b in ((pX, rX), (py, ry), (pmask, rmask)):
        assert a.device.type == "cpu" and np.array_equal(a.numpy(), b)
    for k in ("log_ls", "log_amp", "log_noise"):
        assert pp[k].device.type == "cpu"
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=0, atol=TOL)


def test_nonfinite_rows_are_the_same_as_dropped_rows():
    X, y = inputs(24, 2, 4)
    keep = np.isfinite(y)
    np.testing.assert_array_equal(P.ard_importance(X, y, device="cpu"),
                                  P.ard_importance(X[keep], y[keep], device="cpu"))
    np.testing.assert_array_equal(P.partial_dependence(X, y, device="cpu")[1],
                                  P.partial_dependence(X[keep], y[keep], device="cpu")[1])


class TestImportance:
    def test_dominant_dimension_wins(self):
        rng = np.random.default_rng(0)
        X = rng.random((40, 3)).astype(np.float32)
        # objective depends almost entirely on dim 1
        y = (10.0 * (X[:, 1] - 0.4) ** 2 + 0.01 * X[:, 0]).astype(np.float32)
        imp = P.ard_importance(X, y, device="cpu")
        assert imp.shape == (3,)
        assert abs(imp.sum() - 1.0) < 1e-6
        assert imp[1] > 0.6 and imp[1] == imp.max()

    def test_plot_importance_cli(self, tmp_path, capsys):
        from metaopt_tpu_torch.cli.main import _make_ledger_from_spec, main as cli_main
        from metaopt_tpu_torch.ledger import Experiment
        from metaopt_tpu_torch.space import build_space

        led = str(tmp_path / "led")
        ledger = _make_ledger_from_spec(led, {})
        space = build_space({"a": "uniform(0, 1)", "b": "uniform(0, 1)"})
        exp = Experiment("imp", ledger, space=space, max_trials=20).configure()
        rng = np.random.default_rng(1)
        for _ in range(10):
            pt = {"a": float(rng.random()), "b": float(rng.random())}
            t = exp.make_trial(pt)
            exp.register_trials([t])
            got = exp.reserve_trial("w")
            exp.push_results(got, [{"name": "o", "type": "objective",
                                    "value": 5 * (pt["a"] - 0.5) ** 2}])
        cfg = tmp_path / "cpu.json"
        cfg.write_text(json.dumps({"surrogate": {"device": "cpu"}}))
        rc = cli_main(["plot", "importance", "-n", "imp", "--ledger", led,
                       "--config", str(cfg), "--json"])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        assert set(report["importance"]) == {"a", "b"}
        assert report["importance"]["a"] > report["importance"]["b"]


class TestPartialDependence:
    def test_curve_minimum_tracks_the_true_optimum(self):
        rng = np.random.RandomState(0)
        X = rng.rand(40, 2).astype(np.float32)
        # objective depends on dim 0 only, minimized at 0.7
        y = (X[:, 0] - 0.7) ** 2 + 0.01 * rng.randn(40)
        grid, curves = P.partial_dependence(X, y, n_grid=20, device="cpu")
        assert curves.shape == (2, 20)
        best_g = grid[np.argmin(curves[0])]
        assert abs(best_g - 0.7) < 0.15
        # the irrelevant dim's curve is comparatively flat
        assert np.ptp(curves[1]) < np.ptp(curves[0]) * 0.5

    def test_nonfinite_rows_dropped(self):
        X = np.random.RandomState(1).rand(12, 1).astype(np.float32)
        y = (X[:, 0] - 0.5) ** 2
        y[3] = float("nan")
        grid, curves = P.partial_dependence(X, y, n_grid=8, device="cpu")
        assert np.all(np.isfinite(curves))

    @pytest.mark.parametrize("fn", [P.partial_dependence, P.ard_importance])
    def test_too_few_trials_raises(self, fn):
        with pytest.raises(ValueError, match=">= 2"):
            fn(np.zeros((1, 2), np.float32), np.zeros(1, np.float32), device="cpu")


@pytest.mark.parametrize("fn", [P.partial_dependence, P.ard_importance])
def test_no_device_means_cuda_and_raises_without_it(fn, monkeypatch):
    """Without a ``device`` the analyses resolve ``cuda``; without CUDA
    they raise rather than drift to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = inputs(12, 2, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(X, y)
