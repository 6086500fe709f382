"""The port's Hyperband and BOHB against the reference's, and both CLIs.

Hyperband draws with numpy only, so it must agree with the reference
exactly: the same seed, space and stream of completed trials give identical
suggestions, rung tables, ``is_done`` and state dicts at every step, with
``repetitions`` and ``reduction_factor``, after a restart that replays the
ledger into a fresh instance, and across ``state_dict`` round trips. BOHB's
bookkeeping is Hyperband's: with ``random_fraction=1.0`` it never consults
its models and is exact end to end. With the models on, the port's TPEs are
fed the reference's own threefry draws (``tpe_suggest_fused``'s ``draws``
seam): each per-budget fit agrees with the reference's within 1e-5 and the
suggestions within 1e-5, the same winners.
"""

import json

import jax
import numpy as np
import pytest
import torch

from metaopt_tpu.algo.base import make_algorithm as ref_make_algorithm
from metaopt_tpu.ledger.trial import Trial as RefTrial
from metaopt_tpu.space import build_space as ref_build_space
from metaopt_tpu_torch.algo import BOHB, Hyperband, make_algorithm
from metaopt_tpu_torch.algo import tpe as port_tpe
from metaopt_tpu_torch.ledger.trial import Trial
from metaopt_tpu_torch.ops import tpe_math as P
from metaopt_tpu_torch.space import build_space
from test_torch_tpe import ref_fit, reference_draws

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC = {"x": "uniform(-5, 5)", "lr": "loguniform(1e-4, 1e-1)",
        "opt": "choices(['a', 'b', 'c'])", "epochs": "fidelity(1, 16, base=2)"}


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


def same_points(got, want, exact=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if exact or isinstance(g[k], str):
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)


def drive(port, ref, space, ref_space, steps, seed, exact=True, inflight=None):
    """Suggest a random number of points from both, complete a random
    subset of the in-flight ones in random order (each side its own
    points), and compare after every step. ``inflight`` (the pairs still
    running) carries over between calls."""
    rng = np.random.default_rng(seed)  # drives the stream, not the algorithms
    inflight = [] if inflight is None else inflight
    history = []
    for step in range(steps):
        num = int(rng.integers(1, 5))
        got, want = port.suggest(num), ref.suggest(num)
        same_points(got, want, exact)
        inflight += list(zip(got, want))
        rng.shuffle(inflight)
        k = int(rng.integers(0, len(inflight) + 1))
        done = inflight[:k]
        inflight[:] = inflight[k:]
        trials = [completed(g, objective(g), space) for g, _ in done]
        history += trials
        port.observe(trials)
        ref.observe([completed(w, objective(w), ref_space, RefTrial) for _, w in done])
        assert port.is_done == ref.is_done, step
        if exact:
            assert port.rung_table == ref.rung_table, step
            assert hb_state(port) == hb_state(ref), step
        else:
            occupancy = [(r["bracket"], r["budget"], r["assigned"], r["completed"])
                         for r in port.rung_table]
            assert occupancy == [(r["bracket"], r["budget"], r["assigned"], r["completed"])
                                 for r in ref.rung_table], step
        if port.is_done:
            break
    return history


def hb_state(algo):
    s = algo.state_dict()
    s.pop("models", None)
    return s


# ---------------------------------------------------------------------------
# Hyperband: exact


@pytest.mark.parametrize("config", [
    {"seed": 0, "repetitions": 1},
    {"seed": 3, "repetitions": 2},
    {"seed": 1, "reduction_factor": 4},
    {"seed": 5},
], ids=["hyperband.yaml", "repetitions-2", "eta-4", "forever"])
def test_hyperband_matches_reference_exactly(config):
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    port = make_algorithm(space, {"hyperband": dict(config)})
    ref = ref_make_algorithm(ref_space, {"hyperband": dict(config)})
    assert port.configuration == ref.configuration
    history = drive(port, ref, space, ref_space, 400, seed=11)
    budgets = {t.params["epochs"] for t in history}
    assert budgets == {r["budget"] for r in port.rung_table}
    if config.get("repetitions"):
        assert port.is_done and port._execution == config["repetitions"]
        assert port.suggest(4) == [] == ref.suggest(4)
    else:
        assert port._execution >= 2  # repeats forever


def test_hyperband_bracket_table_and_barrier():
    space = build_space({"x": "uniform(-5, 5)", "epochs": "fidelity(1, 4, base=2)"})
    algo = Hyperband(space, seed=0, repetitions=1)
    assert [[r.capacity for r in b.rungs] for b in algo.brackets] == [[4, 2, 1], [3, 1], [3]]
    assert [[r.budget for r in b.rungs] for b in algo.brackets] == [[1, 2, 4], [2, 4], [4]]
    first = algo.suggest(4)
    assert [p["epochs"] for p in first] == [1, 1, 1, 1]
    more = algo.suggest(10)
    assert sorted(p["epochs"] for p in more) == [2, 2, 2, 4, 4, 4]
    assert algo.suggest(5) == []        # every bracket waits on its barrier
    for i, p in enumerate(first):
        algo.observe([completed(p, i / 10, space)])
    promos = algo.suggest(5)
    assert [p["epochs"] for p in promos] == [2, 2]
    assert {p["x"] for p in promos} == {first[0]["x"], first[1]["x"]}


def test_hyperband_stray_replay_after_restart_continues_the_reference_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"hyperband": {"seed": 2, "repetitions": 2}}
    live = make_algorithm(space, dict(cfg))
    history = []
    while len(history) < 30:
        for p in live.suggest(3):
            t = completed(p, objective(p), space)
            history.append(t)
            live.observe([t])
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    port.observe(history)
    ref.observe([completed(t.params, t.objective, ref_space, RefTrial) for t in history])
    assert port.rung_table == ref.rung_table and hb_state(port) == hb_state(ref)
    assert sum(r["completed"] for r in port.rung_table) == len(history)
    more = drive(port, ref, space, ref_space, 300, seed=2)
    # as the reference does, the replay files promoted trials under the
    # bracket whose entry rung has their budget; their first bracket then
    # re-promotes those lineages, whose trial ids are already observed, so
    # its rung never completes and the run waits at that barrier
    assert more and not port.is_done and port.suggest(4) == [] == ref.suggest(4)
    assert port.rung_table == ref.rung_table


def test_hyperband_replay_of_a_finished_ledger_is_done():
    space = build_space(SPEC)
    live = Hyperband(space, seed=0, repetitions=1)
    done = []
    while pts := live.suggest(4):
        for p in pts:
            t = completed(p, objective(p), space)
            live.observe([t])
            done.append(t)
    replay = Hyperband(space, seed=0, repetitions=1)
    replay.observe(done)
    assert sorted((r["budget"], r["completed"]) for r in replay.rung_table) == sorted(
        (r["budget"], r["completed"]) for r in live.rung_table)
    assert replay.is_done


def test_hyperband_state_dict_round_trip_continues_the_stream():
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    cfg = {"hyperband": {"seed": 4, "repetitions": 2}}
    port, ref = make_algorithm(space, dict(cfg)), ref_make_algorithm(ref_space, dict(cfg))
    running = []
    drive(port, ref, space, ref_space, 12, seed=4, inflight=running)
    assert running
    again = make_algorithm(space, dict(cfg))
    again.load_state_dict(json.loads(json.dumps(port.state_dict())))
    again.rng.bit_generator.state = port.rng.bit_generator.state
    assert again.state_dict() == port.state_dict() and again.rung_table == port.rung_table
    drive(again, ref, space, ref_space, 300, seed=8, inflight=running)
    assert again.is_done


# ---------------------------------------------------------------------------
# BOHB


def make_bohb(config, device="cpu"):
    space, ref_space = build_space(SPEC), ref_build_space(SPEC)
    port = make_algorithm(space, {"bohb": dict(config, device=device)})
    ref = ref_make_algorithm(ref_space, {"bohb": dict(config)})
    return port, ref, space, ref_space


@pytest.mark.parametrize("config", [
    {"seed": 0, "repetitions": 2, "random_fraction": 1.0},
    {"seed": 6, "repetitions": 1, "random_fraction": 1.0, "min_points_in_model": 3},
])
def test_bohb_random_fraction_one_matches_reference_exactly(config):
    port, ref, space, ref_space = make_bohb(config)
    assert port.configuration == ref.configuration
    assert all(m.device.type == "cpu" for m in port._models.values())
    drive(port, ref, space, ref_space, 400, seed=3)
    assert port.is_done
    assert [m._kernel_seed for m in port._models.values()] == [
        m._kernel_seed for m in ref._models.values()]
    for b, m in port._models.items():
        r = ref._models[b]
        assert m._y == r._y and [x.tolist() for x in m._X] == [x.tolist() for x in r._X]
        assert m._launches == 0
    assert port.state_dict()["models"].keys() == ref.state_dict()["models"].keys()


@pytest.fixture
def reference_draws_in_port(monkeypatch):
    """The port's TPE launches with the reference's threefry draws: the
    fit seed maps back to (kernel seed, observation count), whose
    ``fold_in(PRNGKey(kernel seed), n)`` is the reference's fit key."""
    seeds, launches = {}, []
    plain = port_tpe.tpe_suggest_fused

    def with_ref_draws(X, y, n, count, fit_seed, n_choices, cont, gamma, prior_weight,
                       fwn, n_prior, td, *, n_cand, n_out, kmax, equal_weight,
                       n_good_pad, n_bad_pad, n_pools=1):
        ks, n_obs = seeds[fit_seed]
        fit_key = jax.random.fold_in(jax.random.PRNGKey(ks), n_obs)
        draws = reference_draws(fit_key, count, n_pools, n_out * n_cand, X.shape[1])
        launches.append((X.clone(), y.clone(), n, n_choices, gamma, prior_weight, fwn,
                         kmax, equal_weight, n_good_pad, n_bad_pad))
        return plain(X, y, n, count, fit_seed, n_choices, cont, gamma, prior_weight, fwn,
                     n_prior, td, n_cand=n_cand, n_out=n_out, kmax=kmax,
                     equal_weight=equal_weight, n_good_pad=n_good_pad,
                     n_bad_pad=n_bad_pad, n_pools=n_pools, draws=draws)

    def register(algo):
        for m in algo._models.values():
            seeds.update({P.stream_seed(m._kernel_seed, n): (m._kernel_seed, n)
                          for n in range(512)})

    monkeypatch.setattr(port_tpe, "tpe_suggest_fused", with_ref_draws)
    return register, launches


@pytest.mark.parametrize("config,min_launches", [
    ({"seed": 0, "repetitions": 2}, 5),
    ({"seed": 2, "repetitions": 2, "random_fraction": 0.0, "min_points_in_model": 4}, 5),
])
def test_bohb_model_fits_and_winners_match_reference(config, min_launches,
                                                     reference_draws_in_port):
    register, launches = reference_draws_in_port
    port, ref, space, ref_space = make_bohb(config)
    register(port)
    drive(port, ref, space, ref_space, 400, seed=5, exact=False)
    assert port.is_done and ref.is_done
    n_ei = sum(m._launches for m in port._models.values())
    assert n_ei == len(launches) >= min_launches
    for b, m in port._models.items():
        r = ref._models[b]
        np.testing.assert_allclose(m._y, r._y, **TOL)
        assert m._refill_thread is None and m._warmup_thread is None  # never fired
    # the fit against the reference's on the same buffers at the last launch
    # (the winners above already followed every launch's fit; each new
    # padded shape would cost the eager reference ~3 s of XLA compiles)
    for X, y, n, nc, gamma, pw, fwn, kmax, eq, g_pad, b_pad in launches[-1:]:
        fit = P._tpe_fit(X, y, n, nc, gamma, pw, fwn, 0, 1.0, kmax=kmax, equal_weight=eq,
                         n_good_pad=g_pad, n_bad_pad=b_pad)
        want = ref_fit(X.numpy(), y.numpy(), n, nc.numpy(), gamma, pw, fwn, 0, 1.0, kmax, eq,
                       g_pad, b_pad)
        for name, g, r in zip(P.TPEFit._fields, fit, want):
            np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


def test_bohb_model_guides_sampling_after_min_points():
    space = build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 4, base=2)"})
    algo = BOHB(space, seed=3, repetitions=None, random_fraction=0.0,
                min_points_in_model=5, device="cpu")
    for i in range(12):
        x = 0.2 + 0.02 * (i % 3) if i < 8 else 0.9
        algo._models[4]._observe_one(completed({"x": x, "epochs": 4}, abs(x - 0.2), space))
    assert algo._model_for_sampling() is algo._models[4]
    pts = [algo._sample_point()["x"] for _ in range(10)]
    assert sum(abs(x - 0.2) < 0.2 for x in pts) >= 7, pts
    # the device buffer follows the host lists it was fed through _observe_one
    m = algo._models[4]
    assert m._buf.n == 12 and torch.equal(m._buf.Xdev[:12], torch.from_numpy(np.stack(m._X)))
    assert m._buf.ydev[:12].tolist() == [np.float32(v) for v in m._y]


def test_bohb_state_round_trip_restores_models():
    space = build_space({"x": "uniform(0, 1)", "epochs": "fidelity(1, 4, base=2)"})
    a1 = BOHB(space, seed=5, min_points_in_model=3, device="cpu")
    for p in a1.suggest(4):
        a1.observe([completed(p, p["x"], space)])
    a2 = BOHB(space, seed=5, min_points_in_model=3, device="cpu")
    a2.load_state_dict(a1.state_dict())
    assert len(a2._models[1]._y) == len(a1._models[1]._y)
    assert a2.suggest(2) == a1.suggest(2)


def test_bohb_runs_its_models_on_cuda_unless_told_and_never_drifts(monkeypatch):
    space = build_space(SPEC)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BOHB(space, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_algorithm(space, {"bohb": {"seed": 0}})
    algo = BOHB(space, seed=0, device="cpu")
    assert "device" not in algo.configuration["bohb"]
    assert {m.device.type for m in algo._models.values()} == {"cpu"}
