"""The port's ``build_experiment(...).workon()`` path against the JAX package's.

Random search uses numpy only, so the same seed must give identical trial
params, ids and order in both packages. The Transformer objective runs here
on ``device="cpu"`` at a tiny width.
"""

import math

import numpy as np
import pytest
import torch

import metaopt_tpu
import metaopt_tpu_torch
from metaopt_tpu.space.builder import PriorSyntaxError as JaxPriorSyntaxError
from metaopt_tpu.space import build_space as jax_build_space
from metaopt_tpu_torch.models.transformer import train_and_eval
from metaopt_tpu_torch.space import PriorSyntaxError, build_space
from metaopt_tpu_torch.utils.device import resolve_device

SPACES = {
    "smoke": {"lr": "loguniform(1e-4, 3e-3)", "warmup": "uniform(1, 8, discrete=True)"},
    "mixed": {
        "x": "uniform(-5, 5)",
        "n": "randint(1, 10)",
        "act": "choices(['relu', 'gelu', 'tanh'])",
        "w": "normal(0, 2)",
        "m": "uniform(0, 1, shape=2)",
    },
    "weighted": {"opt": "choices({'adam': 0.7, 'sgd': 0.3})", "lr": "loguniform(1e-5, 1)"},
}


def objective(params):
    return sum(float(np.sum(v)) for v in params.values() if not isinstance(v, str))


def trials_of(client):
    return [(t.id, t.params, t.status, t.objective) for t in client.fetch_trials()]


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("seed", [1, 7])
def test_random_search_workon_matches_reference(space, seed):
    runs = []
    for pkg in (metaopt_tpu, metaopt_tpu_torch):
        exp = pkg.build_experiment(
            "parity", space=SPACES[space], algorithm={"random": {"seed": seed}},
            max_trials=6, ledger="memory")
        stats = exp.workon(objective)
        assert stats.completed == 6
        runs.append(trials_of(exp))
    assert runs[0] == runs[1]


def test_manual_suggest_observe_matches_reference():
    runs = []
    for pkg in (metaopt_tpu, metaopt_tpu_torch):
        exp = pkg.build_experiment(
            "manual", space=SPACES["mixed"], algorithm={"random": {"seed": 3}},
            max_trials=4, ledger="memory")
        seen = []
        while not exp.is_done:
            trial = exp.suggest()
            exp.observe(trial, objective(trial.params))
            seen.append((trial.id, trial.params))
        runs.append((seen, exp.best.id, exp.stats["by_status"]))
    assert runs[0] == runs[1]


PRIORS = [
    "uniform(-5, 5)", "loguniform(1e-5, 1e-1)", "normal(0, 1)",
    "uniform(1, 8, discrete=True)", "randint(0, 4)", "choices(['a', 'b', 3])",
    "choices({'x': 0.2, 'y': 0.8})", "fidelity(1, 16, base=4)",
    "uniform(0, 1, shape=[2, 3])", "~uniform(0, 1, default_value=0.5)",
]


@pytest.mark.parametrize("expr", PRIORS)
def test_prior_dsl_parses_like_reference(expr):
    mine = build_space({"p": expr})
    ref = jax_build_space({"p": expr})
    assert mine.configuration == ref.configuration
    assert type(mine["p"]).__name__ == type(ref["p"]).__name__
    assert mine["p"].interval() == ref["p"].interval()
    assert mine.cardinality == ref.cardinality
    for a, b in zip(mine.sample(5, seed=2), ref.sample(5, seed=2)):
        assert np.array_equal(np.asarray(a["p"]), np.asarray(b["p"]))
        assert (a["p"] in mine["p"]) == (b["p"] in ref["p"])


@pytest.mark.parametrize("expr", [
    "uniform(1, __import__('os'))", "normal(0, 1, discrete=True)", "beta(1, 2)",
    "uniform(**{'a': 1})", "x + 1", "uniform(",
])
def test_prior_dsl_rejects_like_reference(expr):
    with pytest.raises(JaxPriorSyntaxError):
        jax_build_space({"p": expr})
    with pytest.raises(PriorSyntaxError):
        build_space({"p": expr})


def test_point_hash_matches_reference():
    from metaopt_tpu.utils.hashing import point_hash as ref_hash
    from metaopt_tpu_torch.utils.hashing import point_hash

    for point in ({"x": 0.1, "n": 3}, {"a": [1.0, -0.0], "s": "relu"},
                  {"f": np.float32(0.5), "i": np.int64(2)}, {"nan": float("nan")}):
        assert point_hash(point) == ref_hash(point)
    assert point_hash({"x": 1, "e": 4}, ignore=("e",)) == ref_hash({"x": 1, "e": 4},
                                                                   ignore=("e",))


TINY = {"vocab": 64, "d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128,
        "max_len": 16, "dropout": 0.0}


def test_workon_trains_tiny_transformer_on_cpu():
    exp = metaopt_tpu_torch.build_experiment(
        "tiny", space=SPACES["smoke"], algorithm={"random": {"seed": 1}},
        max_trials=2, ledger="memory")
    reports = []

    def fn(params):
        rep = {}
        loss = train_and_eval({**params, **TINY}, n_train=32, batch_size=4,
                              seq_len=12, steps=3, device="cpu", report=rep)
        reports.append(rep)
        return loss

    stats = exp.workon(fn)
    done = exp.fetch_trials("completed")
    assert stats.completed == 2 and stats.broken == 0, stats.events
    assert len(done) == 2 and all(math.isfinite(t.objective) for t in done)
    for rep in reports:
        assert rep["steps"] == 3 and len(rep["losses"]) == 3
        assert rep["tokens_per_step"] == 2 * 4 * 12


def test_entry_points_never_drift_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_and_eval({**TINY}, n_train=8, batch_size=4, seq_len=8, steps=1)
    assert resolve_device("cpu").type == "cpu"


def test_unported_ledger_specs_raise(tmp_path):
    """``native:`` is ported (the ledgerstore engine); ``coord://`` names a
    coordinator, and with none listening the reference's typed error is
    raised."""
    from metaopt_tpu_torch.coord.client_backend import CoordUnavailableError

    with pytest.raises(CoordUnavailableError, match="unreachable"):
        metaopt_tpu_torch.build_experiment("x", space=SPACES["smoke"],
                                           ledger="coord://127.0.0.1:1")
    exp = metaopt_tpu_torch.build_experiment("x", space=SPACES["smoke"],
                                             ledger=f"native:{tmp_path / 'l'}")
    assert type(exp.experiment.ledger).__name__ == "NativeFileLedger"
