"""The port's MLP (BASELINE config 2's model) against the JAX package's.

A small flax ``MLP`` (depth 2, width 32) is initialized by flax, converted
with ``params_from_flax`` and fed the same numpy batch in both packages, at
dropout 0 and float32 (the CPU takes f32 matmuls in both). Then TPE drives
a tiny MLP objective through ``workon`` on the CPU into its EI phase.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import metaopt_tpu_torch
from metaopt_tpu.models import mlp as jm
from metaopt_tpu.models.data import batches as ref_batches
from metaopt_tpu.models.data import synthetic_images as ref_synthetic_images
from metaopt_tpu_torch.algo import make_algorithm
from metaopt_tpu_torch.models import mlp as tm
from metaopt_tpu_torch.models.data import batches, synthetic_images

CONFIG2_SPACE = {
    "lr": "loguniform(1e-4, 1e-1)",
    "width": "uniform(64, 1024, discrete=True)",
    "depth": "uniform(1, 6, discrete=True)",
    "dropout": "uniform(0.0, 0.5)",
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    jmodel = jm.MLP(width=32, depth=2, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    tmodel = tm.MLP(32, 2, 0.0)
    tmodel.load_state_dict(tm.params_from_flax(params["params"]), strict=True)
    return dict(x=x, y=y, jmodel=jmodel, params=params, tmodel=tmodel)


def ref_loss(jmodel, p, x, y):
    logits = jmodel.apply(p, x, train=False)
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def test_params_from_flax_covers_every_parameter(setup):
    sd = tm.params_from_flax(setup["params"]["params"])
    assert set(sd) == {k for k, _ in setup["tmodel"].named_parameters()}
    assert sd["hidden.0.weight"].shape == (32, 28 * 28)
    assert sd["head.weight"].shape == (10, 32)


def test_forward_matches_flax(setup):
    want = np.asarray(setup["jmodel"].apply(setup["params"], jnp.asarray(setup["x"]),
                                            train=False))
    got = setup["tmodel"](torch.from_numpy(setup["x"])).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match_flax(setup):
    x, y = jnp.asarray(setup["x"]), jnp.asarray(setup["y"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: ref_loss(setup["jmodel"], p, x, y))(setup["params"])
    model = setup["tmodel"]
    model.zero_grad()
    loss = tm.loss_fn(model, torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4, atol=1e-4)
    want = tm.params_from_flax(jax.tree.map(np.asarray, jgrads["params"]))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_three_adam_steps_match_optax(setup):
    lr = 3e-3
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(8, 28, 28, 1)).astype(np.float32), rng.integers(0, 10, 8))
               for _ in range(3)]
    jmodel, params = setup["jmodel"], setup["params"]
    tx = optax.adam(lr)
    state = tx.init(params)
    for xb, yb in batches:
        grads = jax.grad(lambda p: ref_loss(jmodel, p, jnp.asarray(xb), jnp.asarray(yb)))(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)

    model = tm.MLP(32, 2, 0.0)
    model.load_state_dict(tm.params_from_flax(setup["params"]["params"]))
    opt = tm.Adam(model.parameters(), lr=lr)
    for xb, yb in batches:
        opt.zero_grad()
        tm.loss_fn(model, torch.from_numpy(xb), torch.from_numpy(yb)).backward()
        opt.step()
    want = tm.params_from_flax(jax.tree.map(np.asarray, params["params"]))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_init_follows_flax_distributions():
    model = tm.MLP(256, 2, 0.0).init_like_flax(torch.Generator().manual_seed(0))
    w = model.hidden[1].weight.detach()
    assert float(w.abs().max()) <= 2 / math.sqrt(256) / 0.87962566 + 1e-6
    assert float(w.std()) == pytest.approx(1 / math.sqrt(256), rel=0.05)
    assert not model.hidden[0].bias.any() and not model.head.bias.any()


def test_dropout_uses_its_generator_and_scales_kept_units():
    model = tm.MLP(512, 1, 0.25).init_like_flax(torch.Generator().manual_seed(0))
    x = torch.randn(64, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    state = torch.random.get_rng_state()
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(torch.random.get_rng_state(), state)
    hidden = torch.relu(model.hidden[0](x.reshape(64, -1)))
    mask = torch.rand(hidden.shape, generator=torch.Generator().manual_seed(5)) < 0.75
    dropped = torch.where(mask, hidden / 0.75, 0.0)
    torch.testing.assert_close(a, model.head(dropped), rtol=1e-5, atol=1e-5)
    assert float((~mask).float().mean()) == pytest.approx(0.25, abs=0.02)


def test_synthetic_images_label_by_a_teacher_keyed_alone():
    """Like the reference's: labels are argmax(x @ teacher), and the teacher
    depends on ``teacher_seed`` only, so train and validation draws share
    one labeling function."""
    xr, yr = ref_synthetic_images(jax.random.PRNGKey(0), 64)
    teacher_r = jax.random.normal(jax.random.PRNGKey(7), (784, 10)) / 28
    assert np.array_equal(np.asarray(yr), np.asarray(jnp.argmax(xr.reshape(64, -1) @ teacher_r, -1)))

    teacher = torch.randn((784, 10), generator=torch.Generator().manual_seed(7)) / 28
    for seed in (0, 1):
        x, y = synthetic_images(64, seed=seed, device="cpu")
        assert x.shape == xr.shape and y.shape == yr.shape
        assert torch.equal(y, torch.argmax(x.reshape(64, -1) @ teacher, -1))
    x0, _ = synthetic_images(64, seed=0, device="cpu")
    x1, _ = synthetic_images(64, seed=1, device="cpu")
    assert not torch.equal(x0, x1)
    assert len(torch.unique(synthetic_images(4096, seed=2, device="cpu")[1])) == 10


@pytest.mark.parametrize("n,batch_size", [(64, 16), (70, 16), (7, 8), (9, 1)])
def test_batches_are_a_shuffled_epoch_with_the_remainder_dropped(n, batch_size):
    """Like the reference's: ``n // batch_size`` static-shaped batches of
    (x, y) rows kept together, every row at most once; the same generator
    seed gives the same batches, another seed another order."""
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n)

    def epoch(fn, key):
        return [(np.asarray(bx), np.asarray(by)) for bx, by in fn(x_in, y_in, batch_size, key)]

    x_in, y_in = jnp.asarray(x), jnp.asarray(y)
    ref = epoch(ref_batches, jax.random.PRNGKey(0))
    x_in, y_in = torch.from_numpy(x), torch.from_numpy(y)
    port = epoch(batches, torch.Generator().manual_seed(0))
    for got in (ref, port):
        assert len(got) == n // batch_size
        rows = np.concatenate([by for _, by in got]) if got else np.zeros(0, int)
        assert len(set(rows.tolist())) == len(rows) == (n // batch_size) * batch_size
        for bx, by in got:
            assert bx.shape == (batch_size, 3) and by.shape == (batch_size,)
            assert np.array_equal(bx, x[by])
    again = epoch(batches, torch.Generator().manual_seed(0))
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(port, again))
    if n // batch_size > 1:
        other = epoch(batches, torch.Generator().manual_seed(1))
        assert not all(np.array_equal(a[1], b[1]) for a, b in zip(port, other))


def test_train_and_eval_learns_on_cpu():
    rep = {}
    err = tm.train_and_eval({"lr": 3e-3, "width": 128, "depth": 2, "dropout": 0.1},
                            n_train=1024, n_val=512, batch_size=128, epochs=3,
                            device="cpu", report=rep)
    assert 0.0 <= err < 0.85
    assert rep["steps"] == 24 and len(rep["losses"]) == 3
    assert rep["losses"][-1] < rep["losses"][0]


def test_a_trial_process_never_imports_dynamo():
    # a trial through the CLI is a fresh process: torch.optim's first
    # optimizer would import torch._dynamo there, once per trial
    code = ("import sys; from metaopt_tpu_torch.models import mlp; "
            "mlp.train_and_eval({'lr': 1e-3, 'width': 16, 'depth': 1}, n_train=64, "
            "n_val=32, batch_size=32, epochs=1, device='cpu'); "
            "print(sorted(m for m in sys.modules if m.startswith('torch._dynamo')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("fixed,params,expect_epochs", [
    ({}, {"lr": 1e-3}, None), ({"epochs": 2}, {"lr": 1e-3, "epochs": 5}, 5)])
def test_make_objective_maps_epochs_like_reference(monkeypatch, fixed, params, expect_epochs):
    seen = []
    monkeypatch.setattr(tm, "train_and_eval", lambda hp, **kw: seen.append(kw) or 0.5)
    assert tm.make_objective(**fixed)(params) == 0.5
    assert seen[0].get("epochs") == (expect_epochs if expect_epochs else fixed.get("epochs"))


def test_mlp_entry_point_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.train_and_eval({"lr": 1e-3, "width": 8, "depth": 1}, n_train=8, n_val=8,
                          batch_size=4, epochs=1)


def test_workon_with_tpe_reaches_the_ei_path_on_cpu():
    exp = metaopt_tpu_torch.build_experiment(
        "tpe-mlp", space=CONFIG2_SPACE, max_trials=6, algorithm={"tpe": {
            "seed": 0, "n_initial_points": 3, "device": "cpu"}})
    algo = make_algorithm(exp.space, exp.experiment.algorithm)
    objective = tm.make_objective(n_train=256, n_val=128, batch_size=64, epochs=1,
                                  device="cpu")
    stats = exp.workon(objective, algorithm=algo)
    algo.drain_suggest_ahead()
    done = exp.fetch_trials("completed")
    assert stats.completed == 6 and stats.broken == 0, stats.events
    assert all(math.isfinite(t.objective) and t.params in exp.space for t in done)
    tel = algo.telemetry()
    assert tel["kernel_launches"] >= 1
    assert tel["prefetch_hits"] + tel["prefetch_misses"] >= 3
    assert algo._buf.Xdev.device.type == "cpu" and algo._buf.n >= 5
