"""The port's PPO (BASELINE config 5's trial) against the reference's.

Every stage runs on the same seeded numpy inputs through the JAX package
and the port, on the CPU: ``env_step`` at 1e-6 with the reference's own
``normal(key)`` noise passed in; ``ActorCritic``'s forward through
``params_from_flax`` at 1e-5; the population (ddof 0) advantage std, with a
batch-4 case that ``torch.std``'s default (ddof 1) fails; optax's
``clip_by_global_norm(0.5)`` + Adam at 1e-6 on both sides of the clip. The
whole trial, ``train``, is held against the reference's ``train`` on the
reference's own threefry draws replayed through the port's draw seam
(``GivenDraws``) and its own initial parameters. The init is held by its
distribution (the streams differ), and the port's own draws by the
statistic the reference's runs show (PPO learns from any seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from metaopt_tpu.models import ppo as R
from metaopt_tpu_torch.models import ppo as P

def ref_env_state(rng, n):
    pos = rng.uniform(-5.5, 5.5, (n, R.DIM)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, R.DIM)).astype(np.float32)
    t = rng.integers(190, 200, n).astype(np.int32)
    return pos, vel, t


def test_env_step_matches_reference():
    rng = np.random.default_rng(0)
    n = 256
    pos, vel, t = ref_env_state(rng, n)
    action = rng.normal(0, 1.5, (n, R.DIM)).astype(np.float32)  # many beyond [-1, 1]
    key = jax.random.PRNGKey(3)
    want = R.env_step(R.EnvState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(t)),
                      jnp.asarray(action), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, (n, R.DIM))))
    got = P.env_step(P.EnvState(torch.from_numpy(pos), torch.from_numpy(vel),
                                torch.from_numpy(t)), torch.from_numpy(action), z)
    (ws, wobs, wrew, wdone), (gs, gobs, grew, gdone) = want, got
    assert np.array_equal(gdone.numpy(), np.asarray(wdone))
    assert 0 < int(gdone.sum()) < n      # both the horizon and the radius end some
    assert np.array_equal(gs.t.numpy(), np.asarray(ws.t)) and gs.t.dtype == torch.int32
    for g, w in ((gs.pos, ws.pos), (gs.vel, ws.vel), (gobs, wobs), (grew, wrew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the reward reads the unclipped action and the state before the reset
    assert np.abs(action).max() > 1 and float(grew.min()) < -0.1 * 25


def test_env_reset_from_given_draws():
    k_env = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    ws, wobs = R.env_reset(k_env, 16)
    kp, kv = jax.random.split(k_env)
    pos = jax.random.uniform(kp, (16, R.DIM), minval=-1.0, maxval=1.0)
    vel = jax.random.uniform(kv, (16, R.DIM), minval=-0.5, maxval=0.5)
    gs, gobs = P.env_reset(P.GivenDraws((pos, vel), [], "cpu"), 16)
    assert np.array_equal(gobs.numpy(), np.asarray(wobs))
    assert gs.t.dtype == torch.int32 and not gs.t.any()
    # the port's own reset draws fill the reference's ranges
    s, _ = P.env_reset(P.Draws(0, "cpu"), 4096)
    assert -1 <= s.pos.min() < -0.99 and 0.99 < s.pos.max() < 1
    assert -0.5 <= s.vel.min() < -0.49 and 0.49 < s.vel.max() < 0.5


@pytest.mark.parametrize("hidden", [16, 64])
def test_actor_critic_forward_matches_reference(hidden):
    rng = np.random.default_rng(hidden)
    obs = rng.normal(0, 2, (300, 2 * R.DIM)).astype(np.float32)
    model = R.ActorCritic(hidden=hidden)
    params = model.init(jax.random.PRNGKey(hidden), jnp.asarray(obs))
    # perturb the flax init so that every leaf (biases, log_std) matters
    leaves, tree = jax.tree_util.tree_flatten(params)
    leaves = [leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    want = model.apply(params, jnp.asarray(obs))
    port = P.ActorCritic(hidden=hidden)
    port.load_state_dict(P.params_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_init_follows_flax_distributions():
    hidden = 64
    port = P.ActorCritic(hidden).init_like_flax(torch.Generator().manual_seed(0))
    ref = R.ActorCritic(hidden=hidden).init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"]
    for name in ("pi_0", "pi_1", "v_0", "v_1"):
        got = getattr(port, name).weight.detach().numpy().ravel()
        want = np.asarray(ref[name]["kernel"]).ravel()
        assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3, name
        assert np.abs(got).max() <= 2 * np.sqrt(1 / getattr(port, name).in_features) / 0.8796
        assert not getattr(port, name).bias.any()
    w = port.pi_mean.weight.detach().numpy()             # (DIM, hidden): orthogonal rows
    np.testing.assert_allclose(w @ w.T, 1e-4 * np.eye(R.DIM), atol=1e-9)
    k = np.asarray(ref["pi_mean"]["kernel"])              # the reference's, for the scale
    np.testing.assert_allclose(k.T @ k, 1e-4 * np.eye(R.DIM), atol=1e-9)
    assert port.log_std.tolist() == np.asarray(ref["log_std"]).tolist() == [-0.5, -0.5]


@pytest.mark.parametrize("n", [4, 8192])
def test_advantage_normalization_uses_the_population_std(n):
    adv = np.random.default_rng(n).normal(3, 2, n).astype(np.float32)
    j = jnp.asarray(adv)
    want = np.asarray((j - j.mean()) / (j.std() + 1e-8))
    got = P.normalize(torch.from_numpy(adv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if n == 4:
        t = torch.from_numpy(adv)
        ddof1 = ((t - t.mean()) / (t.std() + 1e-8)).numpy()     # torch.std's default
        assert not np.allclose(ddof1, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below-max-norm", "clipped"])
def test_clip_by_global_norm_and_adam_match_optax(scale):
    rng = np.random.default_rng(1)
    shapes = [(16, 4), (16,), (2,), (1, 16)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = P.Adam(tp, lr=1e-2)
    for _ in range(3):
        grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        P.clip_by_global_norm([p.grad for p in tp], P.MAX_GRAD_NORM)
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
        clipped = min(norm, 0.5)
        assert np.isclose(float(torch.sqrt(sum((p.grad ** 2).sum() for p in tp))), clipped,
                          rtol=1e-5)
        opt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def reference_draws(seed, n_envs, rollout_len, iterations):
    """The reference ``train``'s threefry draws in its split order:
    ``PRNGKey(seed)`` → (key, k_init, k_env); ``env_reset``'s (kp, kv); per
    rollout step (key, ka, ks). Returns k_init and the draws for the port's
    ``GivenDraws``."""
    key = jax.random.PRNGKey(seed)
    key, k_init, k_env = jax.random.split(key, 3)
    kp, kv = jax.random.split(k_env)
    reset = (jax.random.uniform(kp, (n_envs, R.DIM), minval=-1.0, maxval=1.0),
             jax.random.uniform(kv, (n_envs, R.DIM), minval=-0.5, maxval=0.5))
    rollouts = []
    for _ in range(iterations):
        za, ze = [], []
        for _ in range(rollout_len):
            key, ka, ks = jax.random.split(key, 3)
            za.append(np.asarray(jax.random.normal(ka, (n_envs, R.DIM))))
            ze.append(np.asarray(jax.random.normal(ks, (n_envs, R.DIM))))
        rollouts.append((np.stack(za), np.stack(ze)))
    return k_init, reset, rollouts


# (8 envs, 16 steps, hidden 16, 2 updates): the port's return equals the
# reference's to the last bit for "default" and within 9.0e-8 relative for
# "aggressive" (x86-64 CPU, torch 2.13); bound 1e-5 relative
@pytest.mark.parametrize("hp,iterations", [
    ({"lr": 3e-3}, 2),
    ({"lr": 1e-2, "clip_eps": 0.05, "ent_coef": 0.1, "gae_lambda": 0.8}, 3),
], ids=["default", "aggressive"])
def test_whole_trial_matches_reference_on_its_draws(hp, iterations):
    n_envs, rollout_len, hidden, epochs, seed = 8, 16, 16, 2, 0
    hp = dict(hp, hidden=hidden)
    want = R.train(hp, n_envs=n_envs, rollout_len=rollout_len, iterations=iterations,
                   ppo_epochs=epochs, seed=seed)
    k_init, reset, rollouts = reference_draws(seed, n_envs, rollout_len, iterations)
    obs = jnp.concatenate([reset[0], reset[1]], -1)
    params = R.ActorCritic(hidden=hidden).init(k_init, obs)
    rep = {}
    got = P.train(hp, n_envs=n_envs, rollout_len=rollout_len, iterations=iterations,
                  ppo_epochs=epochs, seed=seed, device="cpu",
                  draws=P.GivenDraws(reset, rollouts, "cpu"),
                  params=P.params_from_flax(params), report=rep)
    print(f"port {got!r} reference {want!r} rel {abs(got - want) / abs(want):.3e}")
    assert abs(got - want) <= 1e-5 * abs(want)
    assert rep["advantages"].shape == (rollout_len, n_envs)
    assert rep["iterations"] == iterations and rep["train_s"] > 0


def test_learns_from_its_own_draws_at_full_width():
    # the reference on the CPU gives 87.7-118.8 at 2 iterations and
    # 1.51-1.65 at 32 (seeds 0-3): PPO learns on this environment from any
    # seed, so the port's own stream is held by that statistic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # ~4 s alone; several threads per test worker oversubscribe
    try:
        early = P.train({"lr": 3e-4}, iterations=2, seed=0, device="cpu")
        rep = {}
        late = P.train({"lr": 3e-4}, iterations=32, seed=0, device="cpu", report=rep)
    finally:
        torch.set_num_threads(threads)
    assert early > 50 and late < 5, (early, late)
    st = rep["state"]
    assert st.obs.shape == (64, 2 * P.DIM) and st.opt.count == 32 * 4


def test_make_objective_maps_epochs_to_iterations(monkeypatch):
    seen = {}
    monkeypatch.setattr(P, "train", lambda hp, **kw: seen.update(kw) or 1.5)
    assert P.make_objective(device="cpu", n_envs=8)({"lr": 1e-3, "epochs": 4}) == 1.5
    assert seen == {"device": "cpu", "n_envs": 8, "iterations": 4}


def test_train_runs_on_cuda_unless_told_and_never_drifts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.train({"lr": 1e-3}, iterations=1, n_envs=4, rollout_len=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.make_objective()({"lr": 1e-3, "epochs": 2})
