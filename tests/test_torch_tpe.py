"""The port's TPE against the JAX package's, on the CPU.

Host numpy stages (``UnitCube``, ``pad_pow2``, ``split_pads``,
``adaptive_bandwidths``, the random phase) must be exact. The device stages
(recency weights, fits, category tables, mixture log-pdf, EI) are float32
and held at 1e-5 on identical numpy inputs. ``_tpe_suggest_body`` is fed
the reference's own threefry draws through its ``draws`` seam and must pick
the reference's winners. The port's own draws (the CPU generator here) are
held by a two-sample KS test against the reference's, and the reference's
determinism and behaviour contracts (``tests/unit/test_tpe.py``,
``tests/unit/test_obs_buffer.py``) are restated against the port on
``device="cpu"``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import metaopt_tpu_torch
from metaopt_tpu.algo import TPE as RefTPE
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.ops import tpe_math as R
from metaopt_tpu.space import UnitCube as RefCube
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import TPE, ObservationBuffer, make_algorithm
from metaopt_tpu_torch.algo.obs_buffer import _BULK_THRESHOLD
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ops import tpe_math as P
from metaopt_tpu_torch.space import UnitCube, build_space

TOL = dict(rtol=1e-5, atol=1e-5)


def completed(space, params, objective, trial_cls=Trial):
    t = trial_cls(params=params, experiment="e")
    t.lineage = space.hash_point(params)
    t.transition("reserved")
    t.attach_results([{"name": "o", "type": "objective", "value": objective}])
    t.transition("completed")
    return t


# ---------------------------------------------------------------------------
# host numpy stages: exact


CUBE_SPACE = {
    "u": "uniform(-5, 5)", "lu": "loguniform(1e-4, 1e-1)", "nm": "normal(0, 2)",
    "i": "uniform(1, 6, discrete=True)", "ri": "randint(0, 4)",
    "c": "choices(['a', 'b', 3])", "m": "uniform(0, 1, shape=2)",
    "e": "fidelity(1, 16, base=4)",
}


def same_point(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k], dtype=object), np.asarray(b[k], dtype=object))
        for k in a)


def test_unit_cube_matches_reference_bit_for_bit():
    ref_space, space = ref_build_space(CUBE_SPACE), build_space(CUBE_SPACE)
    ref, port = RefCube(ref_space), UnitCube(space)
    assert port.names == ref.names
    assert np.array_equal(port.categorical_mask, ref.categorical_mask)
    assert np.array_equal(port.n_choices, ref.n_choices)
    points = space.sample(40, seed=3)
    assert all(map(same_point, points, ref_space.sample(40, seed=3)))
    for p in points:
        assert np.array_equal(port.transform(p), ref.transform(p))
    cols = {k: [p[k] for p in points] for k in points[0]}
    assert np.array_equal(port.transform_columns(cols, len(points)),
                          ref.transform_columns(cols, len(points)))
    vecs = np.random.default_rng(0).random((40, port.n_dims))
    vecs[0], vecs[1] = 0.0, 1.0
    assert all(map(same_point, port.untransform_many(vecs), ref.untransform_many(vecs)))


def test_transform_many_matches_reference_bit_for_bit():
    ref_space, space = ref_build_space(CUBE_SPACE), build_space(CUBE_SPACE)
    ref, port = RefCube(ref_space), UnitCube(space)
    points = space.sample(40, seed=4)
    got, want = port.transform_many(points), ref.transform_many(points)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, np.stack([port.transform(p) for p in points]))
    empty = port.transform_many([])
    assert empty.shape == ref.transform_many([]).shape == (0, port.n_dims)
    assert empty.dtype == ref.transform_many([]).dtype


def test_pad_pow2_matches_reference():
    for n in list(range(0, 300)) + [4095, 4096, 4097, 8191, 10001, 12289, 50000]:
        for minimum in (1, 8):
            assert P.pad_pow2(n, minimum) == R.pad_pow2(n, minimum), (n, minimum)


@pytest.mark.parametrize("gamma", [0.25, 0.1, 0.15, 1 / 3, 0.3, 0.7])
def test_split_pads_matches_reference(gamma):
    for n in range(0, 600):
        assert P.split_pads(n, gamma) == R.split_pads(n, gamma), n


def test_adaptive_bandwidths_matches_reference():
    rng = np.random.default_rng(1)
    for size in (0, 1, 2, 3, 7, 50, 150):
        mu = np.sort(rng.random(size))
        assert np.array_equal(P.adaptive_bandwidths(mu), R.adaptive_bandwidths(mu))


TPE_SPACE = {"x": "uniform(-10, 10)", "c": "choices(['a', 'b', 'c'])"}


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_phase_and_kernel_seed_match_reference(seed):
    ref = RefTPE(ref_build_space(TPE_SPACE), seed=seed, n_initial_points=6)
    port = TPE(build_space(TPE_SPACE), seed=seed, n_initial_points=6, device="cpu")
    assert port._kernel_seed == ref._kernel_seed
    assert port.suggest(2) == ref.suggest(2)
    assert port.suggest(3) == ref.suggest(3)
    port.seed_rng(seed + 1)
    ref.seed_rng(seed + 1)
    assert port._kernel_seed == ref._kernel_seed
    assert port.suggest(1) == ref.suggest(1)


def test_config_surface_and_defaults_match_reference():
    ref_sig = inspect.signature(RefTPE.__init__).parameters
    sig = inspect.signature(TPE.__init__).parameters
    assert [p for p in sig if p != "device"] == list(ref_sig)
    for name, p in ref_sig.items():
        assert sig[name].default == p.default, name
    space = build_space(TPE_SPACE)
    cfg = {"seed": 0, "n_initial_points": 10, "gamma": 0.3}
    algo = make_algorithm(space, {"tpe": {**cfg, "device": "cpu"}})
    assert isinstance(algo, TPE) and algo.device.type == "cpu"
    ref_algo = RefTPE(ref_build_space(TPE_SPACE), **cfg)
    assert algo.configuration == ref_algo.configuration


def test_tpe_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = build_space(TPE_SPACE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPE(space, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_algorithm(space, {"tpe": {"seed": 0}})


# ---------------------------------------------------------------------------
# device stages on identical inputs: float32 at 1e-5


def make_buffers(n, d=4, npad=None, seed=0, nan_at=None, cat_col=True):
    """Padded (X, y) as the observation buffer holds them; the last column
    categorical with 3 choices when ``cat_col``."""
    rng = np.random.default_rng(seed)
    npad = npad or P.pad_pow2(n + 1)
    X = np.full((npad, d), 0.5, np.float32)
    X[:n] = rng.random((n, d)).astype(np.float32)
    n_choices = np.ones(d, np.int32)
    if cat_col:
        n_choices[-1] = 3
        X[:n, -1] = ((rng.integers(0, 3, n) + 0.5) / 3).astype(np.float32)
    y = np.full(npad, np.inf, np.float32)
    y[:n] = rng.normal(size=n).astype(np.float32)
    if nan_at is not None and nan_at < n:
        y[nan_at] = np.nan
    return X, y, n_choices


def ref_fit(X, y, n, n_choices, gamma, prior_weight, fwn, n_prior, td, kmax,
            equal_weight, g_pad, b_pad):
    """The γ-split and fits exactly as the reference's ``_tpe_suggest_body``
    computes them (its lines up to the category tables), from its own
    primitives."""
    X, y = jnp.asarray(X), jnp.asarray(y)
    npad = X.shape[0]
    idx = jnp.arange(npad)
    n = jnp.int32(n)
    order = jnp.argsort(jnp.where(idx < n, y, jnp.inf))
    n_below = jnp.minimum(jnp.maximum(1, jnp.ceil(gamma * n).astype(jnp.int32)),
                          jnp.maximum(n, 1))
    n_below = jnp.minimum(n_below, g_pad - 1)
    w_obs = R._recency_weights(n, idx, fwn, equal_weight)
    w_obs = w_obs * jnp.where(idx < n_prior, td, 1.0)
    ng, nb = jnp.minimum(n_below, n), jnp.maximum(n - n_below, 0)
    gpos = jnp.arange(g_pad)
    gsel = order[jnp.minimum(gpos, npad - 1)]
    w_good = jnp.where(gpos < ng, w_obs[gsel], 0.0)
    bpos = n_below + jnp.arange(b_pad)
    bsel = order[jnp.minimum(bpos, npad - 1)]
    w_bad = jnp.where(bpos < n, w_obs[bsel], 0.0)
    Xg, Xb = X[gsel], X[bsel]
    nc = jnp.asarray(n_choices)
    out = (*R._fit_set_device(Xg, w_good, ng, prior_weight),
           *R._fit_set_device(Xb, w_bad, nb, prior_weight),
           R._cat_tables_device(Xg, w_good, nc, prior_weight, kmax),
           R._cat_tables_device(Xb, w_bad, nc, prior_weight, kmax))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("n", [1, 2, 40])
@pytest.mark.parametrize("fwn", [1, 3, 25])
@pytest.mark.parametrize("equal_weight", [False, True])
def test_recency_weights_match_reference(n, fwn, equal_weight):
    npad = P.pad_pow2(n + 1)
    got = P._recency_weights(n, torch.arange(npad), fwn, equal_weight)
    want = R._recency_weights(jnp.int32(n), jnp.arange(npad), fwn, equal_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("count", [0, 1, 2, 9])
def test_fit_set_and_tables_match_reference(count):
    X, _, n_choices = make_buffers(12, npad=16, seed=count)
    w = np.zeros(16, np.float32)
    w[:count] = np.random.default_rng(count).uniform(0.1, 1.0, count)
    got = P._fit_set_device(torch.from_numpy(X), torch.from_numpy(w), count, 1.5)
    want = R._fit_set_device(jnp.asarray(X), jnp.asarray(w), jnp.int32(count), 1.5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    got = P._cat_tables_device(torch.from_numpy(X), torch.from_numpy(w),
                               torch.from_numpy(n_choices), 1.5, 3)
    want = R._cat_tables_device(jnp.asarray(X), jnp.asarray(w), jnp.asarray(n_choices),
                                1.5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


FIT_CASES = {
    # name: (n, nan_at, equal_weight, n_prior, transfer_discount, fwn)
    "n1": (1, None, False, 0, 1.0, 25),
    "n2": (2, None, True, 0, 1.0, 25),
    "ragged-nan": (13, 4, False, 0, 1.0, 5),
    "ragged-nan-equal": (13, 0, True, 0, 1.0, 5),
    "prior-discount": (30, 7, False, 6, 0.25, 10),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_reference(case):
    n, nan_at, eq, n_prior, td, fwn = FIT_CASES[case]
    X, y, n_choices = make_buffers(n, seed=n, nan_at=nan_at)
    g_pad, b_pad = P.split_pads(n, 0.25)
    fit = P._tpe_fit(torch.from_numpy(X), torch.from_numpy(y), n,
                     torch.from_numpy(n_choices), 0.25, 1.0, fwn, n_prior, td,
                     kmax=3, equal_weight=eq, n_good_pad=g_pad, n_bad_pad=b_pad)
    want = ref_fit(X, y, n, n_choices, 0.25, 1.0, fwn, n_prior, td, 3, eq, g_pad, b_pad)
    for name, g, r in zip(P.TPEFit._fields, fit, want):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


def test_nan_objective_sorts_past_the_padding_as_in_the_reference():
    y = np.array([0.3, np.nan, -1.0, np.inf, np.inf, 2.0], np.float32)
    got = torch.argsort(torch.from_numpy(y), stable=True).numpy()
    assert np.array_equal(got, np.asarray(jnp.argsort(jnp.asarray(y))))
    assert got[-1] == 1          # NaN after both +inf rows


def test_mixture_logpdf_and_ei_scores_match_reference():
    rng = np.random.default_rng(4)
    C, N, d = 20, 16, 4
    cand = rng.random((C, d)).astype(np.float32)
    comps = []
    for _ in range(2):
        mu = rng.random((N, d)).astype(np.float32)
        sig = rng.uniform(0.01, 1.0, (N, d)).astype(np.float32)
        logw = np.log(rng.uniform(0.1, 1.0, (N, d))).astype(np.float32)
        logw[N - 5:] = -np.inf                          # padding rows
        comps += [mu, sig, logw]
    got = P._mixture_logpdf(*(torch.from_numpy(a) for a in (cand, *comps[:3])))
    want = R._mixture_logpdf(*(jnp.asarray(a) for a in (cand, *comps[:3])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    cont = np.array([1, 1, 1, 0], np.float32)
    cat_idx = np.zeros((C, d), np.int32)
    cat_idx[:, 3] = rng.integers(0, 3, C)
    tables = [np.log(rng.dirichlet(np.ones(3), d)).astype(np.float32) for _ in range(2)]
    got = P.ei_scores(*(torch.from_numpy(a) for a in (cand, *comps, cont)),
                      torch.from_numpy(cat_idx).long(), *map(torch.from_numpy, tables))
    want = R.ei_scores(*(jnp.asarray(a) for a in (cand, *comps, cont, cat_idx, *tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_categorical_cdf_search_equals_the_reference_compare():
    rng = np.random.default_rng(5)
    logits = np.log(rng.dirichlet(np.ones(9), 4)).astype(np.float32)
    logits[1, 3:6] = -np.inf                             # dead components
    logits[2, :] = 0.0                                   # uniform
    cdf = torch.cumsum(torch.softmax(torch.from_numpy(logits), -1), -1)
    u = rng.random((500, 4)).astype(np.float32)
    u[:9, :] = cdf.T.numpy()                             # u exactly on a CDF step
    u[9] = 0.0
    u = torch.from_numpy(u)
    got = P._categorical_cdf(u, torch.from_numpy(logits))
    want = torch.clamp(torch.sum(u[..., None] > cdf, -1), max=8)
    assert torch.equal(got, want)
    assert not torch.isin(got[:, 1], torch.tensor([3, 4, 5])).any()


def reference_draws(fit_key, count, n_pools, C, d):
    """The reference's per-pool draws: fold_in(fit_key, count + p), split
    in 4, then uniform / normal / normal / uniform of shape (C, d)."""
    pools = []
    for p in range(n_pools):
        kc, kd, kr, ku = jax.random.split(jax.random.fold_in(fit_key, count + p), 4)
        arrs = (jax.random.uniform(kc, (C, d)), jax.random.normal(kd, (C, d)),
                jax.random.normal(kr, (C, d)), jax.random.uniform(ku, (C, d)))
        pools.append(tuple(torch.from_numpy(np.array(a)) for a in arrs))
    return pools


def cdf_margin(fit, pools, kmax, n_choices):
    """Smallest |u - cdf step| over the pools' component and category draws."""
    k = np.maximum(n_choices, 1)
    cat_logits = np.where(np.arange(kmax)[None] < k[:, None], fit.g_cat.numpy(), -np.inf)
    margin = np.inf
    for u_comp, _, _, u_cat in pools:
        for u, logits in ((u_comp, fit.g_logw.T), (u_cat, torch.from_numpy(cat_logits))):
            cdf = torch.cumsum(torch.softmax(logits, -1), -1)
            margin = min(margin, float((u[..., None] - cdf).abs().min()))
    return margin


@pytest.mark.parametrize("n_pools", [1, 2])
@pytest.mark.parametrize("n,nan_at", [(13, 4), (40, None)])
def test_suggest_body_picks_the_reference_winners_from_its_draws(n_pools, n, nan_at):
    X, y, n_choices = make_buffers(n, seed=10 + n, nan_at=nan_at)
    cont = n_choices <= 1
    g_pad, b_pad = P.split_pads(n, 0.25)
    n_cand, n_out, count, d = 24, 4, 3, X.shape[1]
    fit_key = jax.random.fold_in(jax.random.PRNGKey(11), n)
    want = np.asarray(R.tpe_suggest_fused(
        jnp.asarray(X), jnp.asarray(y), n, count, fit_key, jnp.asarray(n_choices),
        jnp.asarray(cont), 0.25, 1.0, 25, n_cand=n_cand, n_out=n_out, kmax=3,
        equal_weight=False, n_good_pad=g_pad, n_bad_pad=b_pad, n_pools=n_pools))
    pools = reference_draws(fit_key, count, n_pools, n_out * n_cand, d)
    args = (torch.from_numpy(X), torch.from_numpy(y), n)
    got = P.tpe_suggest_fused(
        *args, count, 0, torch.from_numpy(n_choices), torch.from_numpy(cont), 0.25,
        1.0, 25, n_cand=n_cand, n_out=n_out, kmax=3, equal_weight=False,
        n_good_pad=g_pad, n_bad_pad=b_pad, n_pools=n_pools, draws=pools).numpy()
    if not np.allclose(got, want, **TOL):
        fit = P._tpe_fit(*args, torch.from_numpy(n_choices), 0.25, 1.0, 25, kmax=3,
                         equal_weight=False, n_good_pad=g_pad, n_bad_pad=b_pad)
        print(f"winners differ; smallest |u - cdf| margin "
              f"{cdf_margin(fit, pools, 3, n_choices):.3e}")
    np.testing.assert_allclose(got, want, **TOL)


def test_port_draws_follow_the_reference_mixture():
    """512 winners from the port's own generator against 512 from the
    reference's threefry stream at one fit: two-sample KS per column,
    p > 1e-3."""
    n = 40
    X, y, n_choices = make_buffers(n, seed=21, nan_at=5)
    cont = n_choices <= 1
    g_pad, b_pad = P.split_pads(n, 0.25)
    kw = dict(n_cand=24, n_out=512, kmax=3, equal_weight=False, n_good_pad=g_pad,
              n_bad_pad=b_pad)
    want = np.asarray(R.tpe_suggest_fused(
        jnp.asarray(X), jnp.asarray(y), n, 0, jax.random.PRNGKey(3),
        jnp.asarray(n_choices), jnp.asarray(cont), 0.25, 1.0, 25, **kw))
    got = P.tpe_suggest_fused(
        torch.from_numpy(X), torch.from_numpy(y), n, 0, P.stream_seed(3, n),
        torch.from_numpy(n_choices), torch.from_numpy(cont), 0.25, 1.0, 25, **kw).numpy()
    for j in range(X.shape[1]):
        p = scipy.stats.ks_2samp(got[:, j], want[:, j]).pvalue
        assert p > 1e-3, (j, p)


def test_pool_draws_are_a_function_of_seed_and_pool_only():
    a = P.pool_draws(P.stream_seed(5, 12), 3, 8, 2, "cpu")
    b = P.pool_draws(P.stream_seed(5, 12), 3, 8, 2, "cpu")
    c = P.pool_draws(P.stream_seed(5, 12), 4, 8, 2, "cpu")
    e = P.pool_draws(P.stream_seed(5, 13), 3, 8, 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], e[0])


# ---------------------------------------------------------------------------
# the reference's TPE contracts (tests/unit/test_tpe.py), restated on the port


def make_tpe(seed=0, **kw):
    space = build_space(TPE_SPACE)
    return space, TPE(space, seed=seed, n_initial_points=5, device="cpu", **kw)


def test_split_weights_fit_and_score_match_reference():
    ref = RefTPE(ref_build_space(TPE_SPACE), seed=7, n_initial_points=5, full_weight_num=4)
    space, port = make_tpe(seed=7, full_weight_num=4)
    assert port.score({"x": 0.0, "c": "a"}) == ref.score({"x": 0.0, "c": "a"}) == 0.0
    for x in [-9, -8, -7, -6, 2, 4, 6, 8, 9, 10, 3]:
        params = {"x": float(x), "c": "abc"[x % 3]}
        port.observe([completed(space, params, abs(x + 8.0))])
        ref.observe([completed(ref.space, params, abs(x + 8.0), RefTrial)])
    below, above = port._split()
    rb, ra = ref._split()
    assert np.array_equal(below, rb) and np.array_equal(above, ra)
    assert np.array_equal(port._weights(11), ref._weights(11))
    for point in ({"x": -8.0, "c": "a"}, {"x": 9.0, "c": "b"}, {"x": 0.5, "c": "c"}):
        assert port.score(point) == pytest.approx(ref.score(point), rel=1e-5, abs=1e-5)


def test_initial_points_random():
    space, tpe = make_tpe()
    pts = tpe.suggest(3)
    assert len(pts) == 3 and all(p in space for p in pts)


def test_ei_suggestions_in_space_and_deterministic():
    space, tpe1 = make_tpe(seed=42)
    _, tpe2 = make_tpe(seed=42)
    obs = [({"x": float(x), "c": c}, (x / 5.0) ** 2)
           for x, c in zip(range(-8, 8, 2), "abcabcab")]
    for params, y in obs:
        tpe1.observe([completed(space, params, y)])
        tpe2.observe([completed(space, params, y)])
    s1, s2 = tpe1.suggest(3), tpe2.suggest(3)
    assert s1 == s2
    assert all(p in space for p in s1)


def test_prefetch_serves_singles_from_one_launch():
    space, tpe = make_tpe(seed=3, pool_prefetch=8)
    for x in range(-8, 4, 2):
        tpe.observe([completed(space, {"x": float(x), "c": "a"}, (x / 5.0) ** 2)])
    tpe.drain_suggest_ahead()
    launches = {"n": 0}
    orig = tpe._launch_ei

    def counting(num):
        launches["n"] += 1
        return orig(num)

    tpe._launch_ei = counting
    singles = [tpe.suggest(1)[0] for _ in range(8)]
    assert launches["n"] == 1
    assert all(p in space for p in singles)
    tpe.observe([completed(space, {"x": 1.0, "c": "b"}, 0.04)])
    tpe.drain_suggest_ahead()
    tpe.suggest(1)
    assert launches["n"] == 2


def test_prefetch_survives_state_roundtrip():
    space, tpe = make_tpe(seed=5, pool_prefetch=8)
    for x in range(-8, 4, 2):
        tpe.observe([completed(space, {"x": float(x), "c": "a"}, (x / 5.0) ** 2)])
    first = tpe.suggest(1)[0]
    state = tpe.state_dict()
    live_rest = [tpe.suggest(1)[0] for _ in range(7)]
    _, tpe2 = make_tpe(seed=999, pool_prefetch=8)
    tpe2.load_state_dict(state)
    assert [tpe2.suggest(1)[0] for _ in range(7)] == live_rest
    assert first is not None


def test_state_roundtrip():
    space, tpe = make_tpe(seed=5)
    for i in range(8):
        tpe.observe([completed(space, {"x": float(i), "c": "a"}, float(i))])
    _, clone = make_tpe(seed=5)
    clone.load_state_dict(tpe.state_dict())
    assert clone.suggest(2) == tpe.suggest(2)


def test_converges_better_than_random():
    space = build_space({"x": "uniform(-10, 10)"})
    tpe = TPE(space, seed=7, n_initial_points=8, device="cpu")
    for _ in range(40):
        p = tpe.suggest(1)[0]
        tpe.observe([completed(space, p, (p["x"] - 3.0) ** 2)])
    best_tpe = min(tpe._y)
    assert best_tpe < 0.15, f"TPE best {best_tpe} too far from optimum"
    xs = [space.sample(1, seed=i)[0]["x"] for i in range(10)]
    assert best_tpe <= min((x - 3.0) ** 2 for x in xs) + 1e-9


def test_categorical_frequencies_steer():
    space = build_space({"c": "choices(['a', 'b', 'c'])", "x": "uniform(0, 1)"})
    tpe = TPE(space, seed=3, n_initial_points=6, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(30):
        c = "abc"[i % 3]
        y = 0.1 if c == "b" else 1.0 + rng.random()
        tpe.observe([completed(space, {"c": c, "x": float(rng.random())}, y)])
    assert sum(1 for p in tpe.suggest(10) if p["c"] == "b") >= 7


def test_fidelity_pinned_to_max():
    space = build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 16, base=4)"})
    tpe = TPE(space, seed=0, n_initial_points=2, device="cpu")
    for i in range(4):
        tpe.observe([completed(space, {"x": i / 4, "epochs": 16}, float(i))])
    assert tpe.suggest(1)[0]["epochs"] == 16


def test_score_ranks_good_region_above_bad():
    space, tpe = make_tpe(seed=7)
    assert tpe.score({"x": 0.0, "c": "a"}) == 0.0
    for x in [-9, -8, -7, -6, 2, 4, 6, 8, 9, 10]:
        tpe.observe([completed(space, {"x": float(x), "c": "a"}, abs(x + 8.0))])
    assert tpe.score({"x": -8.0, "c": "a"}) > tpe.score({"x": 9.0, "c": "a"})


def test_speculative_refill_matches_inline_stream():
    space, eager = make_tpe(seed=11)
    _, lazy = make_tpe(seed=11)
    lazy._suggest_ahead_async = lambda: None
    trials = [completed(space, {"x": float(i), "c": "a"}, float(i)) for i in range(6)]
    for algo in (eager, lazy):
        algo.suggest(1)
        algo.observe(trials)
    eager.drain_suggest_ahead()
    assert eager.suggest(3) == lazy.suggest(3)
    more = [completed(space, {"x": -5.0, "c": "b"}, -1.0)]
    eager.observe(more)
    lazy.observe(more)
    assert eager.suggest(2) == lazy.suggest(2)


def test_warmup_thread_has_no_side_effects():
    space, tpe = make_tpe(seed=3)
    before = tpe.state_dict()
    tpe.suggest(1)
    assert tpe._warmup_thread is not None
    tpe._warmup_thread.join(timeout=120)
    assert not tpe._warmup_thread.is_alive()
    after = tpe.state_dict()
    assert after["pool_idx"] == before["pool_idx"] == 0
    assert after["X"] == before["X"]
    assert tpe.telemetry()["kernel_launches"] == 0


def test_uniform_launch_width_beyond_pool():
    space, tpe = make_tpe(seed=9, pool_prefetch=4)
    for i in range(6):
        tpe.observe([completed(space, {"x": float(i), "c": "a"}, float(i))])
    tpe.drain_suggest_ahead()
    launches0 = tpe.telemetry()["kernel_launches"]
    pts = tpe.suggest(10)
    assert len(pts) == 10 and len(tpe._prefetch) == 6
    assert tpe.telemetry()["kernel_launches"] - launches0 == 1
    assert len({space.hash_point(p) for p in pts}) > 1


def test_batched_pools_bit_identical_to_sequential_singles():
    space, a = make_tpe(seed=17, pool_prefetch=4)
    _, b = make_tpe(seed=17, pool_prefetch=4)
    obs = [completed(space, {"x": float(i) - 3.0, "c": "a"}, float(i % 5)) for i in range(9)]
    for algo in (a, b):
        algo.observe(list(obs))
        algo.drain_suggest_ahead()
    assert a.suggest(8) == [b.suggest(1)[0] for _ in range(8)]


def test_stream_invariant_to_refill_timing_across_observes():
    space, a = make_tpe(seed=21)
    _, b = make_tpe(seed=21)
    b._suggest_ahead_async = lambda: None
    batch1 = [completed(space, {"x": float(i), "c": "a"}, float(i)) for i in range(6)]
    batch2 = [completed(space, {"x": -3.0, "c": "b"}, -2.0)]
    for algo in (a, b):
        algo.suggest(1)
        algo.observe(batch1)
    a.drain_suggest_ahead()
    a.observe(batch2)
    b.observe(batch2)
    a.drain_suggest_ahead()
    assert a.suggest(3) == b.suggest(3)


def test_columnar_observe_equals_per_trial_observe():
    space, a = make_tpe(seed=2)
    _, b = make_tpe(seed=2)
    trials = [completed(space, {"x": float(i) - 4.5, "c": "abc"[i % 3]}, float(i))
              for i in range(7)]

    class Batch(list):
        def columns(self):
            ids = [t.id for t in self]
            cols = {k: [t.params[k] for t in self] for k in self[0].params}
            return ids, cols, np.asarray([t.objective for t in self])

    a.observe(Batch(trials + trials[:2]))
    b.observe(trials)
    assert a._observed == b._observed
    assert all(np.array_equal(x, z) for x, z in zip(a._X, b._X)) and a._y == b._y


# ---------------------------------------------------------------------------
# ObservationBuffer (tests/unit/test_obs_buffer.py), restated on the port


def host_rebuild(X_rows, y_vals, d):
    n = len(y_vals)
    need = P.pad_pow2(n + 1)
    Xb = np.full((need, d), 0.5, np.float32)
    yb = np.full((need,), np.inf, np.float32)
    if n:
        Xb[:n] = np.stack(X_rows).astype(np.float32, copy=False)
        yb[:n] = np.asarray(y_vals, np.float32)
    return Xb, yb


def test_buffer_bit_identical_to_rebuild_at_every_count():
    rng = np.random.default_rng(0)
    d = 5
    buf = ObservationBuffer(d, "cpu")
    X_rows, y_vals = [], []
    for n in range(1, 41):
        X_rows.append(rng.random(d).astype(np.float32))
        y_vals.append(float("nan") if n % 7 == 0 else float(rng.normal()))
        buf.sync(X_rows, y_vals)
        Xb, yb = host_rebuild(X_rows, y_vals, d)
        assert buf.n == n and buf.cap == Xb.shape[0]
        np.testing.assert_array_equal(buf.Xdev.numpy(), Xb)
        np.testing.assert_array_equal(buf.ydev.numpy(), yb)


def test_buffer_bulk_then_incremental_matches():
    rng = np.random.default_rng(1)
    d = 3
    n0 = _BULK_THRESHOLD + 37
    X_rows = [rng.random(d).astype(np.float32) for _ in range(n0)]
    y_vals = [float(v) for v in rng.normal(size=n0)]
    buf = ObservationBuffer(d, "cpu")
    buf.sync(X_rows, y_vals)
    assert buf.bulk_uploads == 1
    for _ in range(35):
        X_rows.append(rng.random(d).astype(np.float32))
        y_vals.append(float(rng.normal()))
        buf.sync(X_rows, y_vals)
    Xb, yb = host_rebuild(X_rows, y_vals, d)
    np.testing.assert_array_equal(buf.Xdev.numpy(), Xb)
    np.testing.assert_array_equal(buf.ydev.numpy(), yb)


def test_buffer_append_h2d_is_o_of_d_and_grow_is_device_side():
    rng = np.random.default_rng(2)
    d = 8
    X_rows = [rng.random(d).astype(np.float32) for _ in range(15)]
    y_vals = [float(v) for v in rng.normal(size=15)]
    buf = ObservationBuffer(d, "cpu")
    buf.sync(X_rows, y_vals)                 # cap = pad_pow2(16) = 16
    for expect_realloc in (True, False):     # 16 rows → cap 32, then 17 rows
        before, reallocs, appends = buf.h2d_bytes, buf.reallocs, buf.appends
        X_rows.append(rng.random(d).astype(np.float32))
        y_vals.append(0.25)
        buf.sync(X_rows, y_vals)
        assert buf.h2d_bytes - before == (d + 1) * 4
        assert buf.appends == appends + 1
        assert buf.reallocs == reallocs + expect_realloc


def test_buffer_shrinking_host_lists_resync_from_scratch():
    rng = np.random.default_rng(4)
    d = 2
    X_rows = [rng.random(d).astype(np.float32) for _ in range(10)]
    y_vals = [float(v) for v in rng.normal(size=10)]
    buf = ObservationBuffer(d, "cpu")
    buf.sync(X_rows, y_vals)
    X_rows, y_vals = X_rows[:4], y_vals[:4]
    buf.sync(X_rows, y_vals)
    Xb, yb = host_rebuild(X_rows, y_vals, d)
    assert buf.n == 4
    np.testing.assert_array_equal(buf.Xdev.numpy(), Xb)
    np.testing.assert_array_equal(buf.ydev.numpy(), yb)
    buf.mark_stale()
    buf.sync(X_rows, y_vals)
    assert buf.bulk_uploads == 3
    np.testing.assert_array_equal(buf.Xdev.numpy(), Xb)


def test_buffer_overlay_matches_host_augmentation_and_charges_pending_rows():
    rng = np.random.default_rng(5)
    d = 6
    X_rows = [rng.random(d).astype(np.float32) for _ in range(11)]
    y_vals = [float(v) for v in rng.normal(size=11)]
    buf = ObservationBuffer(d, "cpu")
    buf.sync(X_rows, y_vals)
    before = buf.h2d_bytes
    pend = [rng.random(d).astype(np.float32) for _ in range(4)]
    Xa, ya, n_eff = buf.overlay(pend, 0.75)
    assert n_eff == 15
    assert buf.h2d_bytes - before == 4 * d * 4 + 4 * 4
    Xb, yb = host_rebuild(X_rows + pend, y_vals + [0.75] * 4, d)
    np.testing.assert_array_equal(Xa.numpy(), Xb)
    np.testing.assert_array_equal(ya.numpy(), yb)


# ---------------------------------------------------------------------------
# the producer's parallel-strategy cycle


def test_mean_strategy_producer_cycle_sets_pending(monkeypatch):
    seen = []
    orig = TPE.set_pending

    def spy(self, trials):
        seen.append(sorted(t.id for t in trials))
        return orig(self, trials)

    monkeypatch.setattr(TPE, "set_pending", spy)
    exp = metaopt_tpu_torch.build_experiment(
        "liar", space=TPE_SPACE, max_trials=8, algorithm={"tpe": {
            "seed": 0, "n_initial_points": 3, "parallel_strategy": "mean",
            "device": "cpu"}})
    held = exp.suggest()                     # stays reserved: a pending trial
    for _ in range(4):
        t = exp.suggest()
        exp.observe(t, (t.params["x"] - 1.0) ** 2)
    last = exp.suggest()
    algo = exp._producer.algorithm
    assert algo.supports_pending and seen and all(held.id in ids for ids in seen[1:])
    assert algo._aug_key is not None and algo._aug_key[1] == (held.id,)
    assert algo.telemetry()["kernel_launches"] >= 1
    assert last.params in exp.space


def test_stream_invariant_under_thread_switch_stress():
    """Refill threads racing suggest() on a short switch interval serve the
    same stream as an instance that never refills (a lost or reordered
    pool commit would shift it)."""
    import sys

    space, a = make_tpe(seed=31, pool_prefetch=2)
    _, b = make_tpe(seed=31, pool_prefetch=2)
    b._suggest_ahead_async = lambda: None
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(24):
            got = [algo.suggest(1 + i % 3) for algo in (a, b)]
            assert got[0] == got[1], i
            for algo in (a, b):
                algo.observe([completed(space, p, (p["x"] - 1.0) ** 2)
                              for p in got[0][:1]])
    finally:
        sys.setswitchinterval(interval)
    a.drain_suggest_ahead(timeout=60)
    assert a._refill_thread is None or not a._refill_thread.is_alive()
    assert a.telemetry()["ahead_launches"] > 0
