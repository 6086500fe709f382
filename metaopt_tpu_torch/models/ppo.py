"""PPO actor-critic — BASELINE config 5 (EvolutionES population search on PPO).

Port of ``metaopt_tpu/models/ppo.py``. The environment is the reference's
zero-egress stand-in for Atari: a vectorized noisy double integrator
rewarded for resting at the origin, held on the device. One
:func:`iteration` is a rollout of ``rollout_len`` steps of ``n_envs``
environments, GAE, and ``ppo_epochs`` full-batch clipped-PPO updates
(no minibatches, no shuffle), each a global-norm clip of 0.5 then Adam.
Everything is float32; :func:`train` keeps TF32 off for its matrix
products. Searchable hparams: ``lr``, ``clip_eps``, ``ent_coef``,
``gae_lambda``, ``hidden``; the fidelity is the number of iterations.

The reference compiles an iteration into one XLA program; here it runs
eagerly (thousands of small kernels an iteration), and the host syncs once
per :func:`train`, when it reads the return. Every random draw of a run
(the initial state, the action noise, the environment noise) goes through
one seam, a :class:`Draws` (a ``torch.Generator`` on the run's device) or
a :class:`GivenDraws` (draws made elsewhere: the reference's, replayed by
the tests, or the same draws on two devices). Weights are initialized in
flax's distributions from a seed on the CPU; ``params_from_flax`` loads
the reference's ``ActorCritic`` parameters instead.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from metaopt_tpu_torch.models.mlp import Adam
from metaopt_tpu_torch.models.transformer import init_dense_like_flax
from metaopt_tpu_torch.utils.device import resolve_device

DIM = 2
DT = 0.1
HORIZON = 200
MAX_GRAD_NORM = 0.5
# float32 constants as the reference's jnp.log of a Python float gives them
_LOG_2PI = float(np.log(np.float32(2 * np.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2 * np.pi * np.e)))


class EnvState(NamedTuple):
    pos: torch.Tensor   # (n_envs, DIM)
    vel: torch.Tensor   # (n_envs, DIM)
    t: torch.Tensor     # (n_envs,) int32


class Draws:
    """Every random draw of a run, from a ``torch.Generator`` on ``device``.

    ``reset(n_envs)`` gives the initial positions in [-1, 1) and velocities
    in [-0.5, 0.5); ``rollout(steps, n_envs)`` one rollout's standard
    normals (action z, environment z), each (steps, n_envs, DIM)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def reset(self, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.rand((2, n_envs, DIM), generator=self.gen, device=self.device)
        return u[0] * 2.0 - 1.0, u[1] - 0.5

    def rollout(self, steps: int, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.randn((2, steps, n_envs, DIM), generator=self.gen, device=self.device)
        return z[0], z[1]


class GivenDraws:
    """Draws made in advance: ``reset`` is (pos, vel), ``rollouts`` one
    (action z, environment z) pair per iteration, moved to ``device``."""

    def __init__(self, reset: Sequence[torch.Tensor],
                 rollouts: Sequence[Sequence[torch.Tensor]], device):
        dev = torch.device(device)

        def put(a):
            return torch.tensor(np.asarray(a), dtype=torch.float32).to(dev)

        self._reset = tuple(put(a) for a in reset)
        self._rollouts = [tuple(put(a) for a in r) for r in rollouts]
        self._next = 0

    def reset(self, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_shape(self._reset, (n_envs, DIM))
        return self._reset

    def rollout(self, steps: int, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self._rollouts[self._next]
        self._next += 1
        _check_shape(out, (steps, n_envs, DIM))
        return out


def _check_shape(draws: Sequence[torch.Tensor], shape: Tuple[int, ...]) -> None:
    if any(tuple(a.shape) != shape for a in draws):
        raise ValueError(f"given draws of shapes {[tuple(a.shape) for a in draws]}, "
                         f"the run needs {shape}")


def env_reset(draws, n_envs: int) -> Tuple[EnvState, torch.Tensor]:
    pos, vel = draws.reset(n_envs)
    state = EnvState(pos, vel, torch.zeros(n_envs, dtype=torch.int32, device=pos.device))
    return state, obs_of(state)


def obs_of(s: EnvState) -> torch.Tensor:
    return torch.cat([s.pos, s.vel], dim=-1)  # (n_envs, 2*DIM)


def env_step(s: EnvState, action: torch.Tensor, z: torch.Tensor
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``action`` accelerates the mass (clipped to [-1, 1] for the dynamics
    only), ``z`` is the standard-normal environment noise; the reward
    favours the origin. Finished environments restart at pos (1, 0) at
    rest: the reward and ``done`` read the state before that reset."""
    vel = 0.98 * s.vel + DT * (action.clamp(-1.0, 1.0) + 0.05 * z)
    pos = s.pos + DT * vel
    t = s.t + 1
    pos_sq = (pos ** 2).sum(-1)
    # 0.1 scale keeps discounted returns O(10) so value regression is tame
    reward = -0.1 * (pos_sq + 0.1 * (vel ** 2).sum(-1) + 0.01 * (action ** 2).sum(-1))
    done = (t >= HORIZON) | (pos_sq > 25.0)
    reset_pos = torch.eye(DIM, dtype=pos.dtype, device=pos.device)[:1]
    pos = torch.where(done[:, None], reset_pos, pos)
    vel = torch.where(done[:, None], 0.0, vel)
    t = torch.where(done, 0, t)
    state = EnvState(pos, vel, t)
    return state, obs_of(state), reward, done


class ActorCritic(nn.Module):
    """Separate actor and critic trunks of two tanh layers of ``hidden``:
    the policy's mean, its state-independent ``log_std``, and the value."""

    def __init__(self, hidden: int = 64, obs_dim: int = 2 * DIM):
        super().__init__()
        self.pi_0 = nn.Linear(obs_dim, hidden)
        self.pi_1 = nn.Linear(hidden, hidden)
        self.pi_mean = nn.Linear(hidden, DIM)
        self.log_std = nn.Parameter(torch.full((DIM,), -0.5))
        self.v_0 = nn.Linear(obs_dim, hidden)
        self.v_1 = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, 1)

    @torch.no_grad()
    def init_like_flax(self, generator: torch.Generator) -> "ActorCritic":
        """flax's initializers from ``generator``: truncated lecun-normal
        kernels and zero biases, ``pi_mean``'s kernel orthogonal with gain
        0.01, ``log_std`` the constant -0.5."""
        for lin in (self.pi_0, self.pi_1, self.v_0, self.v_1, self.v):
            init_dense_like_flax(lin, generator)
        nn.init.orthogonal_(self.pi_mean.weight, gain=0.01, generator=generator)
        nn.init.zeros_(self.pi_mean.bias)
        self.log_std.fill_(-0.5)
        return self

    def forward(self, obs: torch.Tensor):
        x = obs.float()
        a = torch.tanh(self.pi_0(x))
        a = torch.tanh(self.pi_1(a))
        mean = self.pi_mean(a)
        c = torch.tanh(self.v_0(x))
        c = torch.tanh(self.v_1(c))
        value = self.v(c)[..., 0]
        return mean, self.log_std, value


def params_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference ``ActorCritic``'s ``model.init`` parameters (numpy or
    jax arrays; with or without the outer ``params``) as this module's
    ``state_dict``: each ``kernel`` (in, out) transposed to ``weight``."""
    p = variables.get("params", variables)
    out = {"log_std": torch.from_numpy(np.asarray(p["log_std"], np.float32).copy())}
    for name in ("pi_0", "pi_1", "pi_mean", "v_0", "v_1", "v"):
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(p[name]["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(p[name]["bias"], np.float32).copy())
    return out


def policy_logp(mean: torch.Tensor, log_std: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density, ``log 2π`` once per action dimension."""
    var = torch.exp(2 * log_std)
    return -0.5 * ((action - mean) ** 2 / var + 2 * log_std + _LOG_2PI).sum(-1)


def gae(values: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages and returns, (T, n_envs), by the reverse GAE recursion;
    ``v_next`` is ``values[1:]`` then the value of the post-rollout obs."""
    not_done = 1.0 - dones.float()
    v_next = torch.cat([values[1:], last_value[None]], 0)
    delta = rewards + gamma * v_next * not_done - values
    decay = float(np.float32(gamma) * np.float32(lam)) * not_done
    advs = torch.empty_like(values)
    adv = torch.zeros_like(last_value)
    for t in range(values.shape[0] - 1, -1, -1):
        adv = torch.addcmul(delta[t], decay[t], adv, out=advs[t])
    return advs, advs + values


def normalize(adv: torch.Tensor) -> torch.Tensor:
    """The batch's advantages at mean 0 and population (ddof 0) std 1."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def ppo_loss(model: ActorCritic, obs, action, logp_old, adv_n, ret,
             hp: Mapping[str, float]) -> torch.Tensor:
    """Clipped surrogate + ``vf_coef`` · value MSE − ``ent_coef`` ·
    entropy (the sum over the action dimensions)."""
    mean, log_std, value = model(obs)
    logp = policy_logp(mean, log_std, action)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(ratio * adv_n,
                        ratio.clamp(hp["clip_lo"], hp["clip_hi"]) * adv_n).mean()
    vloss = ((value - ret) ** 2).mean()
    entropy = (log_std + _HALF_LOG_2PIE).sum()
    return pg + hp["vf_coef"] * vloss - hp["ent_coef"] * entropy


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: when the global norm g is
    at least ``max_norm`` each gradient becomes (t / g) · max_norm, else it
    stays as it is. No host sync: the choice is made on the device."""
    g = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g < max_norm
    one = torch.ones_like(g)
    torch._foreach_div_(grads, torch.where(keep, one, g))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


@dataclass
class PPOState:
    """What one :func:`iteration` reads and advances."""

    model: ActorCritic
    opt: Adam
    env: EnvState
    obs: torch.Tensor
    draws: Any
    hp: Dict[str, float]
    n_envs: int


def _f32(x: float) -> float:
    return float(np.float32(x))


def setup(hparams: Mapping[str, Any], *, n_envs: int = 64, seed: int = 0, device=None,
          draws=None, params: Optional[Mapping[str, torch.Tensor]] = None) -> PPOState:
    """Model, optimizer and environments for a run on ``device`` (``cuda``
    unless given). ``params`` (a ``state_dict``, e.g. from
    :func:`params_from_flax`) replaces the seeded init; ``draws`` replaces
    the run's :class:`Draws`."""
    device = resolve_device(device)
    model = ActorCritic(hidden=int(hparams.get("hidden", 64)))
    if params is None:
        model.init_like_flax(torch.Generator().manual_seed(2 * seed))
    else:
        model.load_state_dict(params)
    model.to(device)
    if draws is None:
        draws = Draws(2 * seed + 1, device)
    env, obs = env_reset(draws, n_envs)
    eps = np.float32(hparams.get("clip_eps", 0.2))
    hp = {
        # the reference's float32 scalars, and its float32 1 ± clip_eps
        "clip_lo": float(np.float32(1) - eps), "clip_hi": float(np.float32(1) + eps),
        "ent_coef": _f32(hparams.get("ent_coef", 0.01)),
        "vf_coef": _f32(hparams.get("vf_coef", 0.5)),
        "gamma": _f32(hparams.get("gamma", 0.99)),
        "lam": _f32(hparams.get("gae_lambda", 0.95)),
    }
    opt = Adam(model.parameters(), lr=float(hparams.get("lr", 3e-4)))
    return PPOState(model, opt, env, obs, draws, hp, n_envs)


def iteration(st: PPOState, rollout_len: int = 128, ppo_epochs: int = 4
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rollout, GAE and ``ppo_epochs`` full-batch updates; advances
    ``st`` and returns (mean reward · HORIZON, the advantages (T, n_envs))
    as device tensors, without a host sync."""
    model, hp = st.model, st.hp
    z_action, z_env = st.draws.rollout(rollout_len, st.n_envs)
    frames = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
    env, obs = st.env, st.obs
    with torch.no_grad():
        for t in range(rollout_len):
            mean, log_std, value = model(obs)
            action = mean + torch.exp(log_std) * z_action[t]
            logp = policy_logp(mean, log_std, action)
            frames["obs"].append(obs)
            env, obs, reward, done = env_step(env, action, z_env[t])
            for k, v in (("action", action), ("logp", logp), ("value", value),
                         ("reward", reward), ("done", done)):
                frames[k].append(v)
        f = {k: torch.stack(v) for k, v in frames.items()}
        _, _, last_value = model(obs)
        advs, rets = gae(f["value"], f["reward"], f["done"], last_value, hp["gamma"], hp["lam"])
        batch = (f["obs"].flatten(0, 1), f["action"].flatten(0, 1), f["logp"].flatten(0, 1),
                 normalize(advs.flatten()), rets.flatten())
    st.env, st.obs = env, obs
    for _ in range(ppo_epochs):
        loss = ppo_loss(model, *batch, hp)
        st.opt.zero_grad()
        loss.backward()
        clip_by_global_norm([p.grad for p in st.opt.params], MAX_GRAD_NORM)
        st.opt.step()
    return f["reward"].mean() * HORIZON, advs


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matrix products on the card, as the reference's."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def train(
    hparams: Dict[str, Any],
    *,
    n_envs: int = 64,
    rollout_len: int = 128,
    iterations: int = 20,
    ppo_epochs: int = 4,
    seed: int = 0,
    device=None,
    draws=None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    report: Optional[Dict[str, Any]] = None,
) -> float:
    """Run PPO; return the NEGATIVE mean episode return of the last
    iteration (HPO minimizes).

    ``report``, when given, receives ``setup_s`` (model, optimizer and
    environments), ``train_s`` (the iterations, device-synchronized),
    ``iterations``, ``ms_per_iteration``, and the run's final ``state``
    (:class:`PPOState`) and last ``advantages``.
    """
    t_call = time.perf_counter()
    with _no_tf32():
        st = setup(hparams, n_envs=n_envs, seed=seed, device=device, draws=draws,
                   params=params)
        dev = st.obs.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        mean_return, advs = torch.zeros((), device=dev), None
        for _ in range(int(iterations)):
            mean_return, advs = iteration(st, rollout_len, ppo_epochs)
        neg_return = -float(mean_return)  # the run's one host sync
    train_s = time.perf_counter() - t0
    if report is not None:
        report.update(setup_s=t0 - t_call, train_s=train_s, iterations=int(iterations),
                      ms_per_iteration=train_s / max(1, int(iterations)) * 1e3,
                      state=st, advantages=advs)
    return neg_return


def make_objective(**fixed):
    """Objective for InProcessExecutor: params → negated return; the
    ``epochs`` fidelity sets the number of iterations."""

    def objective(params: Dict[str, Any]) -> float:
        kw = dict(fixed)
        if "epochs" in params:
            kw["iterations"] = int(params["epochs"])  # fidelity axis
        return train(params, **kw)

    return objective
