"""The port's MoE feed-forward against the JAX package's, on the CPU.

``metaopt_tpu_torch.models.moe.MoEFeedForward`` fed the parameters flax
initialized for ``metaopt_tpu.models.moe.MoEFeedForward`` and the same numpy
input. Bounds: the router, its softmax, the gates and the balance loss are
f32 (1e-5); the experts multiply in bf16 with f32 accumulation in both
packages, so outputs are held to the bf16 bound 3e-2 (measured: 0 to one
bf16 ulp); ``dropped_fraction`` is a count, held exactly. The reference's
own cases (``tests/unit/test_moe.py``) are restated on the port: the
capacity path equals the dense oracle at ``capacity_factor = E``, a zeroed
router (every probability tied) drops exactly ``(t − cap) / t`` with the
dropped rows zero, top-2 differs from top-1, a perfectly balanced router
gives balance 1. Ties break toward the lower expert, as ``jax.lax.top_k``
breaks them. A small MoE Transformer carried over by ``params_from_flax``
matches the reference's logits, loss (with the 0.01 balance term) and
gradients, and its residual stream turns f32 from the first MoE layer on.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from metaopt_tpu.models import transformer as jt
from metaopt_tpu.models.moe import MoEFeedForward as JaxMoE
from metaopt_tpu_torch.models import transformer as tt
from metaopt_tpu_torch.models.moe import MoEFeedForward, top_k_lower_index_first

BF16 = dict(atol=3e-2, rtol=3e-2)


def flax_moe(d, ff, e, *, x, capacity_factor=1.25, k=1, dropout=0.0, zero_router=False,
             seed=0):
    mod = JaxMoE(d, ff, e, dropout, capacity_factor, k)
    params = nn.meta.unbox(mod.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                    train=False)["params"])
    if zero_router:
        params["router"] = jax.tree.map(jnp.zeros_like, params["router"])
    return mod, jax.tree.map(np.asarray, params)


def port_moe(params, d, ff, e, capacity_factor=1.25, k=1, dropout=0.0):
    mine = MoEFeedForward(d, ff, e, dropout, capacity_factor, k)
    with torch.no_grad():
        mine.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T.copy()))
        mine.router.bias.copy_(torch.from_numpy(params["router"]["bias"]))
        mine.wi.copy_(torch.from_numpy(params["wi"]))
        mine.wo.copy_(torch.from_numpy(params["wo"]))
    return mine


def run_both(x, d=16, ff=32, e=4, capacity_factor=1.25, k=1, zero_router=False, seed=0):
    mod, params = flax_moe(d, ff, e, x=x, capacity_factor=capacity_factor, k=k,
                           zero_router=zero_router, seed=seed)
    want, cols = mod.apply({"params": params}, jnp.asarray(x), train=False,
                           mutable=["aux_loss", "moe_stats"])
    aux = {}
    got = port_moe(params, d, ff, e, capacity_factor, k)(torch.from_numpy(x), aux=aux)
    return got, np.asarray(want), cols, aux


def leaf(cols, name):
    vals = jax.tree.leaves(cols.get(name, {}))
    return [float(np.asarray(v).reshape(())) for v in vals]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.0, 4.0, 0.5])
def test_outputs_balance_and_dropped_fraction_match_flax(k, capacity_factor):
    x = np.random.default_rng(k).standard_normal((2, 8, 16)).astype(np.float32)
    got, want, cols, aux = run_both(x, capacity_factor=capacity_factor, k=k)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 16)
    np.testing.assert_allclose(got.detach().numpy(), want, **BF16)
    np.testing.assert_allclose([float(a) for a in aux["aux_loss"]], leaf(cols, "aux_loss"),
                               rtol=1e-5, atol=1e-6)
    if capacity_factor > 0:
        assert [float(a) for a in aux["moe_stats"]] == leaf(cols, "moe_stats")
    else:  # the dense oracle drops nothing and reports nothing
        assert "moe_stats" not in aux and not leaf(cols, "moe_stats")


@pytest.mark.parametrize("k", [1, 2])
def test_a_zeroed_router_ties_every_expert_and_both_packages_pick_the_lowest(k):
    """Every probability is 1/E: ``jax.lax.top_k`` takes experts 0..k-1, so
    must the port. With capacity 1.0 the first expert's queue holds cap of
    the t tokens: dropped fraction (t·k − k·cap) / (t·k), the dropped rows
    zero."""
    b, s, d, e = 2, 8, 8, 4
    x = np.random.default_rng(8).standard_normal((b, s, d)).astype(np.float32)
    got, want, cols, aux = run_both(x, d=d, ff=16, e=e, capacity_factor=1.0, k=k,
                                    zero_router=True, seed=1)
    np.testing.assert_allclose(got.detach().numpy(), want, **BF16)
    t = b * s
    cap = math.ceil(1.0 * k * t / e)
    dropped = float(aux["moe_stats"][0])
    assert dropped == leaf(cols, "moe_stats")[0]
    assert abs(dropped - (t - cap) / t) < 1e-6      # each expert holds cap of its t items
    nonzero = int((got.reshape(t, d) != 0).any(-1).sum())
    assert nonzero <= cap
    np.testing.assert_array_equal((got.reshape(t, d) != 0).any(-1).numpy(),
                                  (want.reshape(t, d) != 0).any(-1))
    # perfectly uniform probabilities: balance e · Σ frac · (1/E) = 1
    assert abs(float(aux["aux_loss"][0]) - 1.0) < 1e-6


def test_top_k_breaks_ties_toward_the_lower_index_like_jax():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4   # many ties
    for k in (1, 2, 3):
        vals, idx = top_k_lower_index_first(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("k", [1, 2])
def test_capacity_path_equals_the_dense_oracle_at_capacity_e(k):
    d, ff, e = 16, 32, 4
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 8, d)).astype(np.float32))
    dense = MoEFeedForward(d, ff, e, capacity_factor=0.0, router_top_k=k)
    dense.init_tables_like_flax(torch.Generator().manual_seed(0))
    tt.init_dense_like_flax(dense.router, torch.Generator().manual_seed(1))
    capped = MoEFeedForward(d, ff, e, capacity_factor=float(e), router_top_k=k)
    capped.load_state_dict(dense.state_dict())
    aux = {}
    y_cap = capped(x, aux=aux)
    assert float(aux["moe_stats"][0]) == 0.0
    np.testing.assert_allclose(y_cap.detach().numpy(), dense(x).detach().numpy(),
                               atol=1e-4, rtol=1e-4)


def test_top2_gates_normalized_and_output_differs_from_top1():
    """With every expert the identity on positive inputs (wi = wo = I), the
    output is the sum of the chosen gates times x: top-2's renormalized
    gates sum to 1 (y = x), Switch's single gate is the raw top probability
    (y = p_max · x)."""
    d, e = 8, 4
    x = np.abs(np.random.default_rng(12).standard_normal((2, 8, d))).astype(np.float32) + 0.5
    _, params = flax_moe(d, d, e, x=x, capacity_factor=0.0, k=1, seed=1)
    params = dict(params, wi=np.stack([np.eye(d, dtype=np.float32)] * e),
                  wo=np.stack([np.eye(d, dtype=np.float32)] * e))
    one = port_moe(params, d, d, e, 0.0, 1)(torch.from_numpy(x)).detach().numpy()
    two = port_moe(params, d, d, e, 0.0, 2)(torch.from_numpy(x)).detach().numpy()
    xb = torch.from_numpy(x).bfloat16().float().numpy()      # the experts' bf16 input
    np.testing.assert_allclose(two, xb, rtol=1e-6)
    probs = torch.softmax(torch.from_numpy(x @ params["router"]["kernel"]
                                           + params["router"]["bias"]), -1)
    np.testing.assert_allclose(one, probs.max(-1).values.numpy()[..., None] * xb, rtol=1e-5)
    assert not np.allclose(one, two)


def test_single_expert_is_the_plain_ffn():
    d, ff = 16, 32
    x = np.random.default_rng(2).standard_normal((2, 8, d)).astype(np.float32)
    _, params = flax_moe(d, ff, 1, x=x, seed=2)
    y = port_moe(params, d, ff, 1)(torch.from_numpy(x)).detach().numpy()
    ref = np.maximum(x @ params["wi"][0], 0) @ params["wo"][0]
    np.testing.assert_allclose(y, ref, atol=0.15, rtol=0.1)   # bf16 matmuls inside


@pytest.mark.parametrize("capacity_factor,k", [(1.25, 1), (1.25, 2), (0.0, 2)])
def test_dropout_matches_flax_on_its_masks(monkeypatch, capacity_factor, k):
    """Train mode at dropout 0.3: flax's own masks on the (E, cap, f) hidden
    (one per routing choice in the dense oracle, (E, b, s, f)) injected
    through ``GivenDraws``: outputs within the bf16 bound."""
    d, ff, e, rate = 16, 32, 4, 0.3
    masks = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None):
        m = bernoulli(key, p, shape)
        masks.append(np.asarray(m))
        return m

    x = np.random.default_rng(4).standard_normal((2, 8, d)).astype(np.float32)
    mod, params = flax_moe(d, ff, e, x=x, capacity_factor=capacity_factor, k=k,
                           dropout=rate, seed=3)
    monkeypatch.setattr(jax.random, "bernoulli", recording)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x), train=True,
                                rngs={"dropout": jax.random.PRNGKey(4)}), np.float32)
    mine = port_moe(params, d, ff, e, capacity_factor, k, dropout=rate)
    shapes = mine.mask_shapes(2, 8)
    assert [m.shape for m in masks] == shapes and not all(m.all() for m in masks)
    got = mine(torch.from_numpy(x), tt.GivenDraws(masks, attention_seed=0, device="cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want, **BF16)
    clean = mine(torch.from_numpy(x)).detach().numpy()
    assert np.abs(clean - want).max() > 1e-2      # the masks moved the output


def test_init_follows_flax_distributions():
    """flax's lecun_normal counts the expert axis into the tables' fan-in
    (E · in); the router is a plain truncated lecun Dense."""
    d, ff, e = 64, 128, 8
    mine = MoEFeedForward(d, ff, e)
    mine.init_tables_like_flax(torch.Generator().manual_seed(0))
    _, params = flax_moe(d, ff, e, x=np.zeros((1, 4, d), np.float32))
    for name, fan_in in (("wi", e * d), ("wo", e * ff)):
        w = getattr(mine, name).detach()
        assert abs(float(w.std()) - fan_in ** -0.5) < 0.03 * fan_in ** -0.5, name
        assert abs(float(params[name].std()) - fan_in ** -0.5) < 0.03 * fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6


# ---------------------------------------------------------------------------
# a small MoE Transformer through params_from_flax

HP = dict(vocab=64, d_model=64, n_heads=1, d_ff=64, dropout=0.0, max_len=32, n_experts=4)


@pytest.fixture(scope="module", params=[(1, 2), (2, 1), (2, 2)],
                ids=["top1-2+2layers", "top2-1+1layers", "top2-2+2layers"])
def moe_transformer(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("METAOPT_TPU_FLASH", "pallas")
    k, n_layers = request.param
    hp = dict(HP, router_top_k=k, n_layers=n_layers)
    rng = np.random.default_rng(k)
    src = rng.integers(2, hp["vocab"], (2, 12))
    src[1, 9:] = 0
    tgt = rng.permutation(hp["vocab"])[src]
    tgt[src == 0] = 0
    jmodel = jt.make_model(hp)
    z = jnp.zeros((1, 4), jnp.int32)
    params = nn.meta.unbox(jax.jit(
        lambda key: jmodel.init(key, z, z, train=False))(jax.random.PRNGKey(0))["params"])
    tmodel = tt.make_model(hp)
    tmodel.load_state_dict(tt.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    jloss, jgrads = jax.value_and_grad(lambda p: jt.loss_fn(
        jmodel, p, (jnp.asarray(src), jnp.asarray(tgt)), jax.random.PRNGKey(1)))(params)
    bos = np.ones((2, 1), np.int64)
    tgt_in = np.concatenate([bos, tgt[:, :-1]], axis=1)
    jlogits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(src),
                                      jnp.asarray(tgt_in), train=False))
    yield dict(src=src, tgt=tgt, tgt_in=tgt_in, params=params, tmodel=tmodel, k=k,
               n_layers=n_layers, jloss=float(jloss), jgrads=jgrads, jlogits=jlogits)
    mp.undo()


def test_moe_transformer_params_cover_every_parameter(moe_transformer):
    sd = tt.params_from_flax(jax.tree.map(np.asarray, moe_transformer["params"]))
    assert set(sd) == {k for k, _ in moe_transformer["tmodel"].named_parameters()}
    assert "enc.0.mlp.router.weight" in sd and sd["dec.0.mlp.wi"].shape == (4, 64, 64)


def test_moe_transformer_logits_loss_and_gradients_match_flax(moe_transformer):
    """Logits, the loss with its 0.01 balance term, and the gradients.

    Past the first MoE layer the residual stream is f32 and carries each
    package's f32 rounding of the router and the gates (~1e-7, a different
    summation order); the next bf16 cast rounds some of those values to
    neighbouring bf16 numbers, so differences of a bf16 ulp appear and the
    later bf16 layers grow them. The logits are held to the bf16 bound
    relative to their scale (up to ~27 here: a normal(1) table at d 64;
    measured 0.098 at top-2, 2+2 layers). The gradients are held to the bf16
    bound relative to each tensor's scale, as in
    ``tests/test_torch_transformer.py`` (measured worst 0.012 at top-1 and
    0.020 at top-2 over 1+1 layers); at top-2 over 2+2 layers an ulp
    difference in the last layer can flip a relu's derivative and move a few
    entries of that layer's expert tables by up to 0.23 of the scale
    (measured over four inputs: two did, with no routing decision differing),
    so there each gradient is held by its norm, within 3e-2 (measured
    worst 0.012).
    """
    m = moe_transformer
    model = m["tmodel"]
    logits = model(torch.from_numpy(m["src"]), torch.from_numpy(m["tgt_in"]))
    scale = np.abs(m["jlogits"]).max()
    np.testing.assert_allclose(logits.detach().numpy(), m["jlogits"], atol=3e-2 * scale,
                               rtol=3e-2)
    model.zero_grad()
    stats = {}
    loss = tt.loss_fn(model, (torch.from_numpy(m["src"]), torch.from_numpy(m["tgt"])),
                      stats=stats)
    n_moe = 2 * m["n_layers"]
    assert len(stats["aux_loss"]) == n_moe and len(stats["moe_stats"]) == n_moe
    assert stats["blocked_xent"] is False
    np.testing.assert_allclose(float(loss), m["jloss"], rtol=3e-2)
    loss.backward()
    ref = tt.params_from_flax(jax.tree.map(np.asarray, m["jgrads"]))
    for name, p in model.named_parameters():
        mine, want = p.grad.numpy(), ref[name].numpy()
        assert np.isfinite(mine).all(), name
        if name.endswith("k.bias"):   # zero in exact arithmetic: bf16 noise only
            assert np.abs(mine).max() < 1e-3 and np.abs(want).max() < 1e-3, name
            continue
        if m["k"] == 2 and m["n_layers"] == 2:
            np.testing.assert_allclose(np.linalg.norm(mine), np.linalg.norm(want),
                                       rtol=3e-2, err_msg=name)
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(mine, want, atol=3e-2 * scale, rtol=3e-2, err_msg=name)


@pytest.mark.parametrize("n_experts,want", [(0, torch.bfloat16), (4, torch.float32)])
def test_the_residual_stream_turns_f32_after_a_moe_layer(n_experts, want):
    """The reference's MoE returns ``y.astype(x.dtype)`` of the f32 layer-norm
    output, so ``x + mlp(y)`` promotes the bf16 residual to f32 from the first
    MoE layer on; a dense FFN keeps it bf16. Held at both layers of a
    two-layer stack, in both packages."""
    d, ff = 32, 64
    x = np.random.default_rng(5).standard_normal((2, 6, d)).astype(np.float32)
    mask = np.ones((2, 1, 1, 6), bool)
    layers = [jt.EncoderLayer(d, 1, ff, 0.0, n_experts, partitioned=False, name=f"l{i}")
              for i in range(2)]
    jx = jnp.asarray(x, jnp.bfloat16)
    mine_x = torch.from_numpy(x).bfloat16()
    for i, layer in enumerate(layers):
        params = nn.meta.unbox(layer.init(jax.random.PRNGKey(i), jx, jnp.asarray(mask)))
        jx = layer.apply(params, jx, jnp.asarray(mask))
        mine = tt.EncoderLayer(d, 1, ff, 0.0, n_experts)
        p = jax.tree.map(np.asarray, params["params"])
        sd = {k[len("h.0."):]: v for k, v in tt.params_from_flax(
            {"embed": {"embedding": np.zeros((2, d))}, "pos_embed": np.zeros((1, d)),
             "h0": p}).items() if k.startswith("h.0.")}
        mine.load_state_dict(sd)
        mine_x = mine(mine_x, torch.from_numpy(mask))
        assert jx.dtype == (jnp.float32 if want == torch.float32 else jnp.bfloat16), i
        assert mine_x.dtype == want, i
        np.testing.assert_allclose(mine_x.float().detach().numpy(),
                                   np.asarray(jx, np.float32), **BF16)
