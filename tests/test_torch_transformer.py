"""The port's Transformer against the JAX package's, on the CPU.

A small model (2+2 layers, d_model 128, 2 heads of 64, d_ff 128, vocab 64)
is initialized by flax, converted with ``params_from_flax`` and fed the same
numpy batch in both packages. The JAX model routes attention through the
Pallas kernels in interpret mode (``METAOPT_TPU_FLASH=pallas``), the port
through the plain versions of its Hopper kernels. The JAX side runs eagerly:
under ``jax.jit`` XLA fuses bf16 elementwise chains and skips some bf16
roundings, which moves the logits by up to 0.33 at this size (measured), so
the jitted reference is not the like-for-like comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from metaopt_tpu.models import transformer as jt
from metaopt_tpu_torch.models import transformer as tt

HP = dict(vocab=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, dropout=0.0,
          max_len=64)


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    mp.setenv("METAOPT_TPU_FLASH", "pallas")
    rng = np.random.default_rng(0)
    src = rng.integers(2, HP["vocab"], (3, 24))
    src[0, 18:] = 0                     # padded tails
    src[2, 10:] = 0
    tgt = rng.permutation(HP["vocab"])[src]
    tgt[src == 0] = 0
    tgt_in = np.concatenate([np.ones((3, 1), np.int64), tgt[:, :-1]], axis=1)

    jmodel = jt.make_model(HP)
    z = jnp.zeros((1, 4), jnp.int32)
    params = nn.meta.unbox(jax.jit(
        lambda key: jmodel.init(key, z, z, train=False))(jax.random.PRNGKey(0))["params"])
    tmodel = tt.make_model(HP)
    tmodel.load_state_dict(tt.params_from_flax(jax.tree.map(np.asarray, params)),
                           strict=True)

    jlogits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src),
                                      jnp.asarray(tgt_in), train=False))
    jloss, jgrads = jax.value_and_grad(lambda p: jt.loss_fn(
        jmodel, p, (jnp.asarray(src), jnp.asarray(tgt)), jax.random.PRNGKey(1)))(params)
    yield dict(src=src, tgt=tgt, tgt_in=tgt_in, params=params, tmodel=tmodel,
               jlogits=jlogits, jloss=float(jloss), jgrads=jgrads)
    mp.undo()


def test_params_from_flax_covers_every_parameter(setup):
    sd = tt.params_from_flax(jax.tree.map(np.asarray, setup["params"]))
    model_keys = {k for k, _ in setup["tmodel"].named_parameters()}
    assert set(sd) == model_keys
    n_flax = sum(np.asarray(x).size for x in jax.tree.leaves(setup["params"]))
    assert sum(v.numel() for v in sd.values()) == n_flax


def test_logits_match_flax(setup):
    logits = setup["tmodel"](torch.from_numpy(setup["src"]),
                             torch.from_numpy(setup["tgt_in"]))
    assert logits.dtype == torch.float32
    assert logits.shape == (3, 24, HP["vocab"])
    # bf16 bound; measured max |diff| is 0 (the eager reference rounds the
    # same bf16 values at the same places)
    np.testing.assert_allclose(logits.detach().numpy(), setup["jlogits"],
                               atol=3e-2, rtol=3e-2)


def test_loss_matches_flax(setup):
    loss = tt.loss_fn(setup["tmodel"], (torch.from_numpy(setup["src"]),
                                        torch.from_numpy(setup["tgt"])))
    np.testing.assert_allclose(float(loss.detach()), setup["jloss"], rtol=3e-2)


def test_loss_gradients_match_flax(setup):
    model = setup["tmodel"]
    model.zero_grad()
    tt.loss_fn(model, (torch.from_numpy(setup["src"]),
                       torch.from_numpy(setup["tgt"]))).backward()
    ref = tt.params_from_flax(jax.tree.map(np.asarray, setup["jgrads"]))
    for name, p in model.named_parameters():
        mine, want = p.grad.numpy(), ref[name].numpy()
        assert np.isfinite(mine).all(), name
        if name.endswith("k.bias"):
            # exactly zero in exact arithmetic (softmax is shift-invariant
            # per row); both packages leave bf16 noise of ~5e-4
            assert np.abs(mine).max() < 1e-3 and np.abs(want).max() < 1e-3, name
            continue
        # the bf16 bound, taken relative to each tensor's gradient scale:
        # the backward rounds to bf16 at each dense layer in both packages,
        # in different orders (measured worst: 0.022 of the scale)
        scale = np.abs(want).max()
        np.testing.assert_allclose(mine, want, atol=3e-2 * scale, rtol=3e-2,
                                   err_msg=name)


@pytest.mark.parametrize("lr,warmup,steps", [
    (1e-3, 10, 100), (3e-3, 1, 20), (1e-4, 8, 20), (2e-3, 5, 3), (5e-4, 0, 12),
])
def test_schedule_matches_optax(lr, warmup, steps):
    mine = tt.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    for k in range(steps + 5):
        assert abs(mine(k) - float(ref(k))) <= 1e-7, k


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_three_adamw_steps_match_optax(setup, weight_decay):
    """The foreach AdamW against optax.adamw(warmup_cosine_decay_schedule)."""
    hparams = {"lr": 3e-3, "warmup": 2, "weight_decay": weight_decay}
    steps = 10
    params = setup["params"]
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                          params) for _ in range(3)]

    _, tx = jt.trial_setup(hparams, None, 1, 1, 1, steps)
    state = tx.init(params)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    model = tt.make_model(HP)
    model.load_state_dict(tt.params_from_flax(jax.tree.map(np.asarray, params)))
    opt = tt.trial_setup(hparams, model.parameters(), steps)
    named = dict(model.named_parameters())
    for g in grads:
        for name, t in tt.params_from_flax(jax.tree.map(np.asarray, g)).items():
            named[name].grad = t
        opt.step()
    assert opt.updates == 3

    want = tt.params_from_flax(jax.tree.map(np.asarray, jp))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_first_update_uses_zero_learning_rate():
    model = tt.make_model(HP)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = tt.trial_setup({"lr": 1e-2, "warmup": 3}, model.parameters(), 10)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), before[k]), k


def test_fresh_model_holds_no_uninitialized_memory():
    # freed NaNs of the same size are what a torch.empty parameter picks up
    junk = torch.full((HP["max_len"], HP["d_model"]), float("nan"))
    del junk
    model = tt.make_model(HP)
    for k, v in model.named_parameters():
        assert torch.isfinite(v).all(), k
    assert not model.pos_embed.any()


def test_unported_options_raise():
    """The meshes are still unported; MoE feed-forwards and remat are ported
    (tests/test_torch_moe.py, tests/test_torch_remat.py) and build."""
    for kw in ({"tp": 2}, {"sp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError):
            tt.trial_setup({}, tt.make_model(HP).parameters(), 10, **kw)
    assert tt.make_model(dict(HP, n_experts=4)).enc[0].mlp.n_experts == 4
    assert tt.make_model(dict(HP, remat=True)).remat


def test_init_follows_flax_distributions():
    model = tt.make_model(dict(HP, vocab=512, d_model=256, n_heads=4, d_ff=512))
    model.init_like_flax(torch.Generator().manual_seed(0))
    emb = model.embed.weight.detach()
    assert abs(float(emb.std()) - 1.0) < 0.02
    assert abs(float(model.pos_embed.detach().std()) - 0.02) < 0.002
    wi = model.enc[0].mlp.wi.weight.detach()          # lecun: std 1/sqrt(fan_in)
    assert abs(float(wi.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    bound = 2 * 256 ** -0.5 / 0.87962566103423978
    assert float(wi.abs().max()) <= bound + 1e-6     # truncated at 2 std
    wo = model.enc[0].mlp.wo.weight.detach()
    assert abs(float(wo.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert float(model.enc[0].self_attn.q.bias.abs().max()) == 0.0


@pytest.mark.parametrize("fixed,params", [
    ({"steps_per_epoch": 5, "batch_size": 8}, {"lr": 1e-3, "epochs": 3}),
    ({"batch_size": 8}, {"lr": 1e-3, "epochs": 2}),
    ({"steps": 7}, {"lr": 1e-3}),
])
def test_make_objective_maps_epochs_like_reference(monkeypatch, fixed, params):
    calls = []
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "train_and_eval",
                            lambda hp, **kw: calls.append((dict(hp), kw)) or 1.0)
        assert mod.make_objective(**fixed)(params) == 1.0
    assert calls[0] == calls[1]


def test_make_model_takes_the_reference_dropout_default():
    model = tt.make_model({"d_model": 64, "n_heads": 1, "n_layers": 1, "d_ff": 64})
    rates = {m.dropout for m in model.modules() if isinstance(m, (tt.MHA, tt.FeedForward))}
    assert rates == {0.1}
    assert jt.make_model({}).dropout == 0.1


def test_feed_forward_dropout_matches_flax_on_its_mask(monkeypatch):
    """The feed-forward's dropout against flax ``nn.Dropout`` in train mode,
    flax's own mask (recorded from its ``bernoulli`` draw) injected through
    ``GivenDraws``: the outputs are equal."""
    rate, d_model, d_ff = 0.3, 32, 64
    masks = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None):
        m = bernoulli(key, p, shape)
        masks.append(np.asarray(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    ff = jt.FeedForward(d_model, d_ff, rate, partitioned=False)
    x = np.random.default_rng(2).standard_normal((2, 5, d_model)).astype(np.float32)
    params = ff.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)["params"]
    want = np.asarray(ff.apply({"params": params}, jnp.asarray(x), train=True,
                               rngs={"dropout": jax.random.PRNGKey(4)}), np.float32)
    assert len(masks) == 1 and masks[0].shape == (2, 5, d_ff) and not masks[0].all()

    mine = tt.FeedForward(d_model, d_ff, rate)
    p = jax.tree.map(np.asarray, params)
    with torch.no_grad():
        for name in ("wi", "wo"):
            getattr(mine, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            getattr(mine, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
    got = mine(torch.from_numpy(x), tt.GivenDraws(masks, attention_seed=0, device="cpu"))
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    # without draws (evaluation) nothing is dropped
    clean = mine(torch.from_numpy(x)).float().detach().numpy()
    ref = np.asarray(ff.apply({"params": params}, jnp.asarray(x), train=False), np.float32)
    np.testing.assert_array_equal(clean, ref)


def test_given_draws_reject_a_mask_of_the_wrong_shape():
    mine = tt.FeedForward(8, 16, 0.1)
    with pytest.raises(ValueError, match="shape"):
        mine(torch.zeros(2, 3, 8), tt.GivenDraws([np.ones((2, 3, 8), bool)], 0, "cpu"))


def test_a_train_step_imports_no_torch_dynamo():
    """A trial process pays no ``torch._dynamo`` import: the foreach AdamW
    replaced ``torch.optim.AdamW`` (~11 s per fresh process on the card's
    host)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from metaopt_tpu_torch.models import transformer as tt\n"
        "tt.train_and_eval({'lr': 1e-3, 'dropout': 0.1, 'd_model': 64, 'n_heads': 1,\n"
        "                   'n_layers': 1, 'd_ff': 64, 'vocab': 64}, steps=2, n_train=8,\n"
        "                  batch_size=4, seq_len=8, device='cpu')\n"
        "print('torch._dynamo' in sys.modules)\n")
    repo = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo, env={**__import__("os").environ,
                                                     "PYTHONPATH": repo,
                                                     "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


SMALL = dict(vocab=64, d_model=64, n_heads=1, n_layers=1, d_ff=64)


def test_train_and_eval_with_dropout_is_finite_reproducible_and_learns():
    kw = dict(steps=30, n_train=64, batch_size=16, seq_len=12, device="cpu")
    hp = {"lr": 3e-3, "warmup": 2, "dropout": 0.1, **SMALL}
    reps = [{}, {}]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = [tt.train_and_eval(hp, report=r, **kw) for r in reps]
        other = tt.train_and_eval(hp, seed=1, **kw)
    finally:
        torch.set_num_threads(n_threads)
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert reps[0]["losses"] == reps[1]["losses"]
    assert other != losses[0]
    first, last = reps[0]["losses"][:5], reps[0]["losses"][-5:]
    assert np.mean(last) < 0.8 * np.mean(first)
    assert reps[0]["restored"] is False and reps[0]["save_s"] >= 0.0


def test_dropout_draws_depend_on_seed_and_step():
    """Each step's draws come from (seed, step), as the reference folds the
    step into its key: the same pair repeats them, another pair does not."""
    def draw(seed, step):
        d = tt.Draws(seed, step, "cpu")
        return d.ffn_keep((64,), 0.5), torch.randint(0, 2 ** 31, (1,), generator=d.attention)

    a, b = draw(0, 3), draw(0, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for other in (draw(0, 4), draw(1, 3)):
        assert not torch.equal(a[0], other[0]) and not torch.equal(a[1], other[1])
