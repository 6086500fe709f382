"""The port's Transformer and LM on tp, sp and ep meshes against the JAX
package's, on four CPU ranks.

Restates ``tests/unit/test_models.py``'s mesh cases
(``test_sharded_train_step_runs``,
``test_blocked_xent_routing_explicit_shards_vs_mesh``;
``test_sp_train_step_runs`` and ``test_tp_sp_ep_in_one_jit`` are in
``tests/test_torch_mesh_cli.py``, beside the entry points' own launch) and holds the numbers: flax initializes a
small model, ``params_from_flax`` carries its weights across, and each
rank loads its ``shard_params`` slice; the same numpy batches then go
through two train steps of the reference's jitted ``make_train_step``
(one device: its GSPMD run computes the same function) and of the port's
on dp 2 × tp 2, dp 2 × sp 2 and (MoE) dp 2 × ep 2. Losses within the bf16 bound
of ``tests/test_torch_transformer.py`` (3e-2; the model computes in bf16,
and the mesh sums its partial products in another order), and within
2e-3 of the port's own one-rank run (measured: at most 1.6e-4). The
reference's losses are computed once per model (the tp and sp cases share
them), to keep the file inside its time.

(The MoE's global capacity over dp × ep is held in
``tests/test_torch_parallel.py``, the tp × ep Transformer in
``tests/test_torch_mesh_cli.py``.) Dropout at rate 0.1 on a
dp 2 × tp 2 mesh takes the reference's own feed-forward masks and
attention keep bits (its CPU attention's ``bernoulli``), sliced by each
rank from the whole masks through ``GivenDraws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_mesh_legs as legs
from metaopt_tpu.models import lm as jlm, transformer as jt
from metaopt_tpu_torch.models import lm, transformer as tt
from metaopt_tpu_torch.parallel.launch import RankPool

CALL_S = 80
HP = dict(vocab=61, d_model=128, n_heads=4, n_layers=1, d_ff=64, dropout=0.0, max_len=32,
          lr=1e-3, warmup=1)
MESHES = {"tp2": [("dp", 2), ("tp", 2)], "sp2": [("dp", 2), ("sp", 2)],
          "ep2": [("dp", 2), ("ep", 2)]}
STEPS = 2


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=CALL_S) as p:
        yield p


def hp_for(mesh):
    return dict(HP, n_experts=4) if mesh == "ep2" else dict(HP)


def flax_state(which, hp, seed=0):
    model = (jt.make_model if which == "tfm" else jlm.make_lm)(hp)
    z = jnp.zeros((1, 8), jnp.int32)
    args = (z, z) if which == "tfm" else (z,)
    params = nn.meta.unbox(jax.jit(lambda key: model.init(key, *args, train=False))(
        jax.random.PRNGKey(seed))["params"])
    state = {k: v.numpy() for k, v in tt.params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    return model, params, state


def batches(which, seed=0, b=4, s=16, vocab=61):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if which == "tfm":
            src, tgt = rng.integers(1, vocab, (b, s)), rng.integers(1, vocab, (b, s))
            tgt[1, 12:] = 0
            out.append((src.astype(np.int64), tgt.astype(np.int64)))
        else:
            toks = rng.integers(1, vocab, (b, s + 1))
            toks[1, 13:] = 0
            out.append(toks.astype(np.int64))
    return out


_REFERENCE = {}


def reference_losses(which, model, params, hp, data):
    """The reference's losses (computed once per model: the tp and sp cases
    share one)."""
    key = (which, tuple(sorted(hp.items())))
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference_losses(which, model, params, hp, data)
    return _REFERENCE[key]


def _reference_losses(which, model, params, hp, data):
    _, tx = jt.trial_setup(hp, None, 1, 1, 1, 10)
    make = jt.make_train_step if which == "tfm" else jlm.make_lm_train_step
    step = jax.jit(make(model, tx))
    opt_state, losses = tx.init(params), []
    for batch in data:
        batch = tuple(map(jnp.asarray, batch)) if which == "tfm" else jnp.asarray(batch)
        params, opt_state, loss = step(params, opt_state, batch, jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses


def one_rank_losses(which, hp, state, data):
    make = tt.make_model if which == "tfm" else lm.make_lm
    model = make(hp)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    opt = tt.trial_setup(hp, model.parameters(), 10)
    step = tt.make_train_step(model, opt) if which == "tfm" else lm.make_lm_train_step(model, opt)
    as_t = torch.as_tensor
    return [float(step(tuple(map(as_t, b)) if which == "tfm" else as_t(b))) for b in data]


@pytest.mark.parametrize("which", ["tfm", "lm"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_match_the_reference(pool, which, mesh):
    hp = hp_for(mesh)
    model, params, state = flax_state(which, hp)
    data = batches(which)
    parts = pool.run(legs.model_steps, MESHES[mesh], which, hp, state, data)
    assert all(p == parts[0] for p in parts)   # every rank reports the summed loss
    np.testing.assert_allclose(parts[0], reference_losses(which, model, params, hp, data),
                               rtol=3e-2)
    np.testing.assert_allclose(parts[0], one_rank_losses(which, hp, state, data), rtol=2e-3)
    assert np.isfinite(parts[0]).all()


def test_blocked_xent_routing_reads_the_mesh(pool):
    # 4·64·512·50000 ≈ 6.55 GB of f32 logits: blocked unsharded, not at dp 4
    batch, seq, vocab = 64, 512, 50_000
    assert tt.blocked_xent_enabled(batch, seq, vocab)
    assert not tt.blocked_xent_enabled(batch, seq, vocab, shards=4)
    assert jt.blocked_xent_enabled(batch, seq, vocab)
    for axes, want in (([("dp", 4)], False), ([("tp", 4)], True),
                       ([("dp", 2), ("sp", 2)], False)):
        got = pool.run(legs.xent_routing, axes, batch, seq, vocab)
        assert got == [(want, True, False)] * 4, axes


def test_dropout_on_the_references_masks(pool, monkeypatch):
    """Rate 0.1 on dp 2 × tp 2: the reference LM's own masks (its
    feed-forward ``nn.Dropout`` and its CPU attention's keep bits), whole,
    through ``GivenDraws``; each rank keeps its slices. One step's loss
    against the reference's."""
    hp = dict(HP, dropout=0.1)
    model, params, state = flax_state("lm", hp)
    toks = batches("lm")[0]
    masks = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None):
        m = bernoulli(key, p, shape)
        if not isinstance(m, jax.core.Tracer):
            masks.append(np.asarray(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    jloss = float(jlm.lm_loss_fn(model, params, jnp.asarray(toks), jax.random.PRNGKey(4)))
    monkeypatch.undo()
    ffn = [m for m in masks if m.ndim == 3]
    attention = [m for m in masks if m.ndim == 4]
    assert len(ffn) == 1 and len(attention) == 1
    assert all(0.8 < m.mean() < 0.97 for m in ffn + attention)
    parts = pool.run(legs.model_steps, MESHES["tp2"], "lm", hp, state, [toks], [ffn],
                     [attention])
    np.testing.assert_allclose(parts[0][0], jloss, rtol=3e-2)
