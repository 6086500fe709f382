"""The port's GP-BO against the reference's, on the CPU.

Deterministic stages on the same numpy inputs (f32): ``_kernel``,
``_masked_gram`` and ``_neg_mll`` within 1e-5; the MLL's gradient within
1e-4 of its largest entry; ``gp_chol_full`` within 1e-5; the hyperparameters after
``gp_fit_mll``'s 60 Adam steps (``gp.yaml``'s ``fit_iters``) within 1e-4:
measured 4.1e-5 at worst over eight inputs — the gradient's f32 rounding
(~1e-6 relative) compounds over the steps, and Adam's division by √v̂
scales a small gradient's error up. A chain of ``gp_chol_append`` equals a
full refactorization; the MLL is invariant to padding; non-finite
objectives drop out. Random draws cannot match (threefry against
Philox/mt19937), so the reference's own candidates are fed to the port
through the ``draws`` seam: the port picks the reference's winners, in
``gp_acquire_fused`` (one and two pools), the cold ``gp_suggest_fused``,
and a whole ``gp.yaml`` run of ``GPBO`` on Rosenbrock. The restore
replays the factor bitwise (port against port). The reference's
``tests/unit/test_gp_bo.py`` contracts are restated against the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.algo import gp_bo as R
from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import GPBO, make_algorithm
from metaopt_tpu_torch.algo import gp_bo as P
from metaopt_tpu_torch.algo.obs_buffer import CholeskyFactor, _chol_grow
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.models.objectives import rosenbrock
from metaopt_tpu_torch.ops import tpe_math
from metaopt_tpu_torch.space import build_space

FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=0, atol=1e-4)
FIT = dict(rtol=0, atol=1e-4)
SPACE = {"x": "uniform(-5, 5)", "y": "uniform(-5, 5)"}
ROSEN = {"x": "uniform(-5, 10)", "y": "uniform(-5, 10)"}
GP_YAML = {"seed": 0, "n_initial_points": 8, "fit_iters": 60}


def buffers(N, n, d, seed, nan_at=None):
    rng = np.random.default_rng(seed)
    X = np.full((N, d), 0.5, np.float32)
    X[:n] = rng.random((n, d), dtype=np.float32)
    y = np.full(N, np.inf, np.float32)
    y[:n] = (rng.normal(size=n) * 4 + 2).astype(np.float32)
    if nan_at is not None:
        y[nan_at] = np.nan
    fin = y[:n][np.isfinite(y[:n])]
    return X, y, float(np.mean(fin)), float(np.std(fin) + 1e-8)


def params_of(seed, d):
    rng = np.random.default_rng(100 + seed)
    return {"log_ls": rng.normal(-1.0, 0.3, d).astype(np.float32),
            "log_amp": np.float32(rng.normal(0, 0.3)),
            "log_noise": np.float32(rng.normal(-4, 0.5))}


def jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def th(p):
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in p.items()}


def t(a):
    return torch.as_tensor(np.asarray(a))


def mask_and_std(X, y, n, mu, sd):
    live = (np.arange(len(y)) < n) & np.isfinite(y)
    return live.astype(np.float32), np.where(live, (y - mu) / sd, 0.0).astype(np.float32)


CASES = [(8, 5, 2, 0, None), (16, 11, 4, 1, 3), (32, 20, 3, 2, 7)]


@pytest.mark.parametrize("N,n,d,seed,nan_at", CASES)
def test_kernel_gram_and_mll_within_1e_5(N, n, d, seed, nan_at):
    X, y, mu, sd = buffers(N, n, d, seed, nan_at)
    p = params_of(seed, d)
    mask, ys = mask_and_std(X, y, n, mu, sd)
    np.testing.assert_allclose(
        P._kernel(t(X), t(X[:5]), th(p)["log_ls"], th(p)["log_amp"]).numpy(),
        np.asarray(R._kernel(jnp.asarray(X), jnp.asarray(X[:5]), *(jx(p)[k] for k in
                                                                   ("log_ls", "log_amp")))),
        **FWD)
    np.testing.assert_allclose(
        P._masked_gram(t(X), t(mask), *th(p).values()).numpy(),
        np.asarray(R._masked_gram(jnp.asarray(X), jnp.asarray(mask), *jx(p).values())), **FWD)
    want, gwant = jax.value_and_grad(R._neg_mll)(jx(p), jnp.asarray(X), jnp.asarray(ys),
                                                 jnp.asarray(mask))
    theta = P._pack(th(p)).requires_grad_(True)
    got = P._neg_mll(P._unpack(theta), t(X), t(ys), t(mask))
    (g,) = torch.autograd.grad(got, theta)
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    gref = np.concatenate([np.asarray(gwant["log_ls"]), [float(gwant["log_amp"])],
                           [float(gwant["log_noise"])]])
    # relative to the gradient's largest entry (up to ~140 on these
    # ill-conditioned grams; measured 1.5e-5 of it at worst)
    np.testing.assert_allclose(g.numpy(), gref, rtol=0,
                               atol=GRAD["atol"] * max(1.0, float(np.abs(gref).max())))


@pytest.mark.parametrize("N,n,d,seed,nan_at", CASES)
def test_fit_and_factors_match_the_reference(N, n, d, seed, nan_at):
    X, y, mu, sd = buffers(N, n, d, seed, nan_at)
    want, wdrift = R.gp_fit_mll(jnp.asarray(X), jnp.asarray(y), n, mu, sd,
                                R._default_params(d), 0.05, fit_iters=60)
    got, gdrift = P.gp_fit_mll(t(X), t(y), n, mu, sd, P._default_params(d, "cpu"), 0.05,
                               fit_iters=60)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **FIT)
    assert abs(float(gdrift) - float(wdrift)) <= 1e-4
    p = params_of(seed, d)
    L = P.gp_chol_full(t(X), t(y), n, th(p))
    np.testing.assert_allclose(L.numpy(), np.asarray(R.gp_chol_full(
        jnp.asarray(X), jnp.asarray(y), n, jx(p))), **FWD)
    # a chain of row extensions from an early anchor equals the full factor
    chain = P.gp_chol_full(t(X), t(y), 2, th(p))
    ref_chain = R.gp_chol_full(jnp.asarray(X), jnp.asarray(y), 2, jx(p))
    for i in range(2, n):
        chain = P.gp_chol_append(chain, t(X), t(y), i, th(p))
        ref_chain = R.gp_chol_append(ref_chain, jnp.asarray(X), jnp.asarray(y), i, jx(p))
    np.testing.assert_allclose(chain.numpy(), L.numpy(), **FWD)
    np.testing.assert_allclose(chain.numpy(), np.asarray(ref_chain), **FWD)
    # growth by an identity corner commutes with the factorization
    X2 = np.concatenate([X, np.full((N, d), 0.5, np.float32)])
    y2 = np.concatenate([y, np.full(N, np.inf, np.float32)])
    np.testing.assert_allclose(_chol_grow(L, 2 * N).numpy(),
                               P.gp_chol_full(t(X2), t(y2), n, th(p)).numpy(), **FWD)


def test_padding_invariant_mll_and_nonfinite_rows_dropped():
    rng = np.random.default_rng(0)
    p = th({"log_ls": np.full(2, np.log(0.3), np.float32), "log_amp": np.float32(0.0),
            "log_noise": np.float32(np.log(1e-2))})
    X5 = rng.random((5, 2)).astype(np.float32)
    y5 = rng.standard_normal(5).astype(np.float32)
    exact = float(P._neg_mll(p, t(X5), t(y5), torch.ones(5)))
    X8 = np.concatenate([X5, np.zeros((3, 2), np.float32)])
    y8 = np.concatenate([y5, np.zeros(3, np.float32)])
    padded = float(P._neg_mll(p, t(X8), t(y8), t([1.0] * 5 + [0.0] * 3)))
    assert abs(exact - padded) < 1e-5
    # a NaN objective in the buffer is a dead row: the fit and the factor
    # equal those of the buffer without it
    X, y, mu, sd = buffers(16, 9, 3, 5, nan_at=4)
    keep = [i for i in range(16) if i != 4]
    Xk, yk = X[keep + [15]], y[keep + [15]]
    a, _ = P.gp_fit_mll(t(X), t(y), 9, mu, sd, P._default_params(3, "cpu"), 0.05, fit_iters=20)
    b, _ = P.gp_fit_mll(t(Xk), t(yk), 8, mu, sd, P._default_params(3, "cpu"), 0.05, fit_iters=20)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **FWD)
    L = P.gp_chol_full(t(X), t(y), 9, a).numpy()
    np.testing.assert_array_equal(L[4], np.eye(16, dtype=np.float32)[4])
    # a matrix that is not positive definite factors to NaN, not an error
    bad = P._cholesky(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))
    assert torch.isnan(bad).all()


def ref_pool_draws(fit_key, count, n_pools, n_cand, d):
    """The reference's candidate draws: per pool, fold_in(fit_key, count +
    p) split in two, uniforms (n_cand // 2, d) and normals for the rest."""
    out = []
    for p in range(n_pools):
        k_u, k_p = jax.random.split(jax.random.fold_in(fit_key, count + p))
        out.append((torch.from_numpy(np.array(jax.random.uniform(k_u, (n_cand // 2, d)))),
                    torch.from_numpy(np.array(
                        jax.random.normal(k_p, (n_cand - n_cand // 2, d))))))
    return out


@pytest.mark.parametrize("n_pools", [1, 2])
@pytest.mark.parametrize("N,n,d,seed,nan_at", CASES[1:])
def test_acquire_picks_the_reference_winners_from_its_candidates(n_pools, N, n, d, seed,
                                                                 nan_at):
    X, y, mu, sd = buffers(N, n, d, seed, nan_at)
    p = params_of(seed, d)
    L = R.gp_chol_full(jnp.asarray(X), jnp.asarray(y), n, jx(p))
    key = jax.random.fold_in(jax.random.PRNGKey(7 + seed), n)
    want = np.asarray(R.gp_acquire_fused(jnp.asarray(X), jnp.asarray(y), L, n, mu, sd, key, 3,
                                         jx(p), n_cand=64, n_out=4, n_pools=n_pools))
    got = P.gp_acquire_fused(t(X), t(y), t(np.asarray(L)), n, mu, sd, 0, 3, th(p), n_cand=64,
                             n_out=4, n_pools=n_pools,
                             draws=ref_pool_draws(key, 3, n_pools, 64, d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cold_suggest_picks_the_reference_winners():
    X, y, mu, sd = buffers(16, 10, 3, 9, nan_at=2)
    key = jax.random.PRNGKey(11)
    want = np.asarray(R.gp_suggest_fused(jnp.asarray(X), jnp.asarray(y), 10, mu, sd, key, 0.05,
                                         fit_iters=60, n_cand=128, n_out=4))
    k_u, k_p, _ = jax.random.split(key, 3)
    draws = (torch.from_numpy(np.array(jax.random.uniform(k_u, (64, 3)))),
             torch.from_numpy(np.array(jax.random.normal(k_p, (64, 3)))))
    got = P.gp_suggest_fused(t(X), t(y), 10, mu, sd, 0, 0.05, fit_iters=60, n_cand=128,
                             n_out=4, draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_top_puts_the_lower_index_first_on_ties():
    ei = torch.tensor([[0.5, 2.0, 2.0, 0.1, 2.0], [1.0, 1.0, 1.0, 1.0, 1.0]])
    assert P._top(ei, 3).tolist() == [[1, 2, 4], [0, 1, 2]]
    np.testing.assert_array_equal(P._top(ei, 3).numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(ei.numpy()), 3)[1]))


def completed(space, params, objective, trial_cls=Trial):
    tr = trial_cls(params=params, experiment="e")
    tr.lineage = space.hash_point(params)
    tr.transition("reserved")
    tr.attach_results([{"name": "o", "type": "objective", "value": objective}])
    tr.transition("completed")
    return tr


@pytest.fixture
def reference_candidates_in_port(monkeypatch):
    """The port's GP launches draw the reference's threefry candidates: the
    fit seed maps back to (kernel seed, observation count), whose
    ``fold_in(PRNGKey(kernel seed), n)`` is the reference's fit key."""
    seeds = {}

    def ref_draws(fit_seed, pool, n_cand, d, device):
        ks, n_obs = seeds[fit_seed]
        fit_key = jax.random.fold_in(jax.random.PRNGKey(ks), n_obs)
        return ref_pool_draws(fit_key, pool, 1, n_cand, d)[0]

    def register(algo):
        seeds.update({tpe_math.stream_seed(algo._kernel_seed, k): (algo._kernel_seed, k)
                      for k in range(128)})

    monkeypatch.setattr(P, "gp_pool_draws", ref_draws)
    return register


def test_gp_yaml_run_picks_the_reference_winners(reference_candidates_in_port):
    space, ref_space = build_space(ROSEN), ref_build_space(ROSEN)
    port = make_algorithm(space, {"gp": {**GP_YAML, "device": "cpu"}})
    ref = ref_make_algorithm(ref_space, {"gp": dict(GP_YAML)})
    assert port.configuration == ref.configuration
    reference_candidates_in_port(port)
    for step in range(16):
        [got], [want] = port.suggest(1), ref.suggest(1)
        if step < GP_YAML["n_initial_points"]:
            assert got == want, step
        else:
            np.testing.assert_allclose([got["x"], got["y"]], [want["x"], want["y"]],
                                       rtol=1e-5, atol=1e-5, err_msg=str(step))
        port.observe([completed(space, got, rosenbrock(got))])
        ref.observe([completed(ref_space, want, rosenbrock(want), RefTrial)])
        port.drain_suggest_ahead()
        ref.drain_suggest_ahead()
    tel = port.telemetry()
    assert tel["kernel_launches"] == ref.telemetry()["kernel_launches"] >= 2
    assert tel["chol_anchors"] == ref.telemetry()["chol_anchors"]
    assert tel["chol_extends"] == ref.telemetry()["chol_extends"] > 0


class TestGPBO:
    def test_registered_with_the_reference_configuration(self):
        port = make_algorithm(build_space(SPACE), {"gp": {"seed": 1, "device": "cpu"}})
        ref = ref_make_algorithm(ref_build_space(SPACE), {"gp": {"seed": 1}})
        assert isinstance(port, GPBO) and port.configuration == ref.configuration
        with pytest.raises(ValueError, match="parallel_strategy"):
            GPBO(build_space(SPACE), parallel_strategy="min", device="cpu")

    def test_random_phase_then_model_phase(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=0, n_initial_points=4, device="cpu")
        pts = algo.suggest(4)
        for i, p in enumerate(pts):
            algo.observe([completed(space, p, float(i))])
        model_pts = algo.suggest(2)
        assert len(model_pts) == 2 and all(p in space for p in model_pts)

    def test_converges_on_quadratic(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=3, n_initial_points=6, fit_iters=40, device="cpu")
        best = np.inf
        for _ in range(24):
            pt = algo.suggest(1)[0]
            obj = (pt["x"] - 1.0) ** 2 + (pt["y"] + 2.0) ** 2
            best = min(best, obj)
            algo.observe([completed(space, pt, obj)])
        assert best < 0.5

    def test_state_roundtrip(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=5, n_initial_points=3, device="cpu")
        for i in range(5):
            algo.observe([completed(space, algo.suggest(1)[0], float(i))])
        clone = GPBO(space, seed=5, n_initial_points=3, device="cpu")
        clone.load_state_dict(json.loads(json.dumps(algo.state_dict())))
        assert clone.suggest(2) == algo.suggest(2)

    def test_pool_drain_draws_fresh_candidates(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=9, n_initial_points=4, pool_prefetch=4, device="cpu")
        for i in range(4):
            algo.observe([completed(space, algo.suggest(1)[0], float(i))])
        seen = set()
        for _ in range(6):
            key = space.hash_point(algo.suggest(1)[0])
            assert key not in seen
            seen.add(key)

    def test_liar_rows_extend_a_copy_of_the_factor(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=1, n_initial_points=3, parallel_strategy="max",
                    device="cpu")
        for i in range(5):
            algo.observe([completed(space, algo.suggest(1)[0], float(i))])
        algo.drain_suggest_ahead()
        pend = [Trial(params=p, experiment="e") for p in space.sample(3, seed=4)]
        algo.set_pending(pend)
        algo.drain_suggest_ahead()
        pts = algo.suggest(2)
        base = algo._factor.L.clone()
        assert len(pts) == 2 and algo._aug is not None and algo._aug[2] == 8
        assert torch.equal(base[:5, :5], algo._aug[3][:5, :5])
        assert algo._factor.rows == 5


class TestIncrementalCholesky:
    @staticmethod
    def full_L(algo):
        buf, f = algo._buf, algo._factor
        yd = buf.ydev.numpy()[: f.cap]
        mask = ((np.arange(f.cap) < f.rows) & np.isfinite(yd)).astype(np.float32)
        K = P._masked_gram(buf.Xdev[: f.cap], t(mask), *algo._params.values())
        return np.linalg.cholesky(K.numpy().astype(np.float64))

    def test_extension_matches_full_refactorization(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=2, n_initial_points=3, pool_prefetch=1, reanchor_every=64,
                    fit_iters=10, device="cpu")
        algo._suggest_ahead_async = lambda: None
        rng = np.random.default_rng(0)
        checked = 0
        for k in range(12):
            pt = algo.suggest(1)[0]
            if algo._factor.anchor_n >= 0:
                np.testing.assert_allclose(algo._factor.L.numpy().astype(np.float64),
                                           self.full_L(algo), atol=1e-3, rtol=1e-3)
                checked += 1
            n0 = len(algo._y)
            algo.observe([completed(space, pt, (pt["x"] - 1) ** 2 + (pt["y"] + 2) ** 2)])
            if len(algo._y) == n0:
                filler = {"x": float(rng.uniform(-5, 5)), "y": float(rng.uniform(-5, 5))}
                algo.observe([completed(space, filler, 1.0)])
            if k == 4:
                algo.observe([completed(space, {"x": 3.3, "y": 3.3}, float("nan"))])
        tel = algo._factor.telemetry()
        assert checked >= 8 and tel["chol_anchors"] == 1
        assert tel["chol_extends"] >= 8 and tel["chol_grows"] >= 1

    def test_reanchor_keeps_equivalence(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=4, n_initial_points=3, pool_prefetch=1, reanchor_every=2,
                    refit_iters=5, fit_iters=10, device="cpu")
        algo._suggest_ahead_async = lambda: None
        for i in range(9):
            algo.observe([completed(space, algo.suggest(1)[0], float((i * 7) % 5))])
        algo.suggest(1)
        assert algo._factor.telemetry()["chol_anchors"] >= 3
        np.testing.assert_allclose(algo._factor.L.numpy().astype(np.float64),
                                   self.full_L(algo), atol=1e-3, rtol=1e-3)

    def test_restore_replays_factor_bitwise(self):
        space = build_space(SPACE)

        def fresh():
            a = GPBO(space, seed=6, n_initial_points=3, pool_prefetch=1, reanchor_every=4,
                     device="cpu")
            a._suggest_ahead_async = lambda: None
            return a

        algo = fresh()
        for i in range(7):
            algo.observe([completed(space, algo.suggest(1)[0], float(i % 4))])
        algo.suggest(1)
        clone = fresh()
        clone.load_state_dict(json.loads(json.dumps(algo.state_dict())))
        clone.suggest(1)
        assert clone._factor.trace() == algo._factor.trace()
        assert torch.equal(algo._factor.L, clone._factor.L)

    def test_incremental_off_is_cold_refit_per_launch(self):
        space = build_space(SPACE)
        algo = GPBO(space, seed=8, n_initial_points=3, pool_prefetch=1, incremental=False,
                    device="cpu")
        algo._suggest_ahead_async = lambda: None
        for i in range(6):
            algo.observe([completed(space, algo.suggest(1)[0], float(i))])
        algo.suggest(1)
        tel = algo._factor.telemetry()
        assert tel["chol_extends"] == 0 and tel["chol_anchors"] >= 4
        np.testing.assert_allclose(algo._factor.L.numpy().astype(np.float64),
                                   self.full_L(algo), atol=1e-3, rtol=1e-3)

    def test_factor_trace_and_telemetry(self):
        f = CholeskyFactor()
        f.anchor(torch.eye(8), 3, 8)
        f.grow(16)
        f.append_row(torch.eye(16), 3)
        assert f.trace() == {"anchor_n": 3, "anchor_cap": 8, "ops": [["g", 16], ["a", 3]]}
        assert f.current(4, 16) and not f.current(4, 8)
        assert f.telemetry() == {"chol_anchors": 1, "chol_extends": 1, "chol_grows": 1,
                                 "chol_drift_refits": 0}


def test_stream_invariant_under_thread_switch_stress():
    """Suggest-ahead refills racing suggest() on a short switch interval
    serve the same stream as an instance that never refills (a lost or
    reordered pool commit, or a factor mutated outside the launch lock,
    would shift it)."""
    import sys
    import threading

    space = build_space(SPACE)
    a = GPBO(space, seed=31, n_initial_points=3, pool_prefetch=2, reanchor_every=3,
             refit_iters=5, fit_iters=10, device="cpu")
    b = GPBO(space, seed=31, n_initial_points=3, pool_prefetch=2, reanchor_every=3,
             refit_iters=5, fit_iters=10, device="cpu")
    b._suggest_ahead_async = lambda: None
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(14):
            got = [algo.suggest(1 + i % 3) for algo in (a, b)]
            assert got[0] == got[1], i
            for algo in (a, b):
                p = got[0][0]
                algo.observe([completed(space, p, (p["x"] - 1.0) ** 2 + p["y"] ** 2)])
    finally:
        sys.setswitchinterval(interval)
    a.drain_suggest_ahead(timeout=60)
    assert all(not t.is_alive() for t in threading.enumerate() if t.name == "gpbo-refill")
    assert a.telemetry()["ahead_launches"] >= 5
