"""The port's Ulysses attention against the JAX package's, on CPU ranks.

Restates ``tests/unit/test_ulysses.py`` on four CPU ranks (one pool for the
file): the reference's ``ulysses_attention`` on a CPU mesh of the same
shape against the port's (its local attention the plain versions of
K1–K3 here), each rank taking its (dp rows, sp positions, tp heads)
slices, outputs and gradients reassembled (where compiling the
reference's shard_map per shape would cost more than the file's time, its
oracle ``_reference_attention`` stands in). Bounds: f32 1e-5 forward and
1e-4 for gradients, bf16 3e-2. Then the heads error, ``METAOPT_TPU_SP_IMPL``, and a
Transformer on a dp × sp mesh routed through it (four all-to-alls per
attention call: q, k and v in, the output back), and through the ring,
against the reference's model on the same parameters (unsharded: the
reference's own test holds its sharded model to that), within the bf16
bound of ``tests/test_torch_transformer.py`` (3e-2 of the logits' scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

import torch_mesh_legs as legs
from metaopt_tpu.ops.attention import _reference_attention
from metaopt_tpu.ops.ulysses import sp_impl as jsp_impl, ulysses_attention as julysses
from metaopt_tpu.parallel.mesh import make_mesh as jmake_mesh
from metaopt_tpu_torch.models import transformer as tt
from metaopt_tpu_torch.ops.ulysses import sp_impl
from metaopt_tpu_torch.parallel.launch import RankPool
from test_torch_ring_attention import assemble

CALL_S = 60


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=CALL_S) as p:
        yield p


def qkv(seed, b=2, s=32, h=4, d=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, d)) / np.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def reference(axes, q, k, v, mask=None):
    mesh = jmake_mesh(axes, devices=jax.devices()[:4])
    return np.asarray(julysses(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask), mesh=mesh))


@pytest.mark.parametrize("axes", [
    [("sp", 4)], [("dp", 2), ("sp", 2)], [("sp", 2), ("tp", 2)],
], ids=["sp4", "dp2-sp2", "sp2-tp2"])
def test_matches_reference(pool, axes):
    q, k, v = qkv(0)
    out = assemble(pool.run(legs.sp_attention, axes, "ulysses", q, k, v, None, False), axes,
                   "out")
    if axes == [("dp", 2), ("sp", 2)]:   # the reference's own on a CPU mesh of the same shape
        np.testing.assert_allclose(out, reference(axes, q, k, v), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(_reference_attention(q, k, v, None)),
                               atol=1e-5, rtol=1e-5)


def test_masked_and_causal_match_reference(pool):
    axes = [("dp", 2), ("sp", 2)]
    q, k, v = qkv(1)
    rng = np.random.default_rng(2)
    mask = rng.random((2, 32, 32)) < 0.8
    mask[:, :, 0] = True
    out = assemble(pool.run(legs.sp_attention, axes, "ulysses", q, k, v, mask, False), axes,
                   "out")
    np.testing.assert_allclose(out, reference(axes, q, k, v, mask), atol=1e-5, rtol=1e-5)
    causal = np.broadcast_to(np.tril(np.ones((32, 32), bool)), (2, 32, 32)).copy()
    causal[:, 20:] = False   # fully masked rows give zeros
    out = assemble(pool.run(legs.sp_attention, axes, "ulysses", q, k, v, causal, False), axes,
                   "out")
    np.testing.assert_allclose(out, np.asarray(_reference_attention(q, k, v, causal)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, 20:], 0.0, atol=1e-6)


def test_grads_match_reference(pool):
    axes = [("sp", 2), ("dp", 2)]
    q, k, v = qkv(3)
    parts = pool.run(legs.sp_attention, axes, "ulysses", q, k, v, None, True)

    def loss(q, k, v):   # the reference's oracle, as its own test holds its Ulysses
        return jnp.sum(_reference_attention(q, k, v, None) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    for key, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(assemble(parts, axes, key), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_bf16_io(pool):
    import torch

    axes = [("sp", 4)]
    q, k, v = (torch.from_numpy(t).bfloat16() for t in qkv(4))
    parts = pool.run(legs.sp_attention, axes, "ulysses", q, k, v, None, False)
    assert all(p["out"].dtype == torch.bfloat16 for p in parts)
    want = np.asarray(_reference_attention(*(np.asarray(t.float()) for t in (q, k, v)), None))
    np.testing.assert_allclose(assemble(parts, axes, "out"), want, atol=3e-2, rtol=3e-2)


def test_indivisible_heads_raises(pool):
    q, _, _ = qkv(4, h=2)
    errs = pool.run(legs.sp_error, [("sp", 4)], "ulysses", q[:, :8])
    assert all("divisible" in e for e in errs)
    with pytest.raises(ValueError, match="divisible"):
        julysses(*(jnp.asarray(q),) * 3, mesh=jmake_mesh([("sp", 4)], devices=jax.devices()[:4]))


def test_sp_impl_env(monkeypatch):
    monkeypatch.delenv("METAOPT_TPU_SP_IMPL", raising=False)
    assert sp_impl() == jsp_impl() == "ring"
    monkeypatch.setenv("METAOPT_TPU_SP_IMPL", "ulysses")
    assert sp_impl() == jsp_impl() == "ulysses"
    monkeypatch.setenv("METAOPT_TPU_SP_IMPL", "nope")
    for fn in (sp_impl, jsp_impl):
        with pytest.raises(ValueError, match="ring/ulysses"):
            fn()


def test_dropout_seeds_are_distinct_per_coordinate_and_deterministic(pool):
    axes = [("dp", 2), ("sp", 2)]
    q, k, v = qkv(5)
    a, b, c = (assemble(pool.run(legs.sp_attention, axes, "ulysses", q, k, v, None, False,
                                 (0.3, seed)), axes, "out") for seed in ((9, 0), (9, 0), (10, 0)))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


HP = {"d_model": 128, "n_heads": 4, "n_layers": 1, "d_ff": 64, "vocab": 50, "dropout": 0.0}


@pytest.fixture(scope="module")
def reference_model():
    from metaopt_tpu.models.transformer import make_model

    jmodel = make_model(HP)
    src = (np.arange(2 * 16).reshape(2, 16) % 49 + 1).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), src, src, train=False)
    want = np.asarray(jmodel.apply(params, src, src, train=False), np.float32)
    state = {k: v.numpy() for k, v in tt.params_from_flax(
        jax.tree.map(np.asarray, nn.meta.unbox(params["params"]))).items()}
    return src, state, want


@pytest.mark.parametrize("impl", ["ulysses", "ring"])
def test_transformer_routes_through_sp_attention(pool, reference_model, impl):
    """Same parameters on a dp × sp mesh: the port's Transformer (routed
    through ``impl``) against the reference's."""
    src, state, want = reference_model
    parts = pool.run(legs.model_forward, [("dp", 2), ("sp", 2)], "tfm", HP, state, src, src,
                     impl)
    got = np.concatenate([np.concatenate([parts[2 * i + j]["logits"].numpy() for j in range(2)],
                                         1) for i in range(2)], 0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=3e-2 * scale, rtol=3e-2)
    calls = parts[0]["calls"]
    if impl == "ulysses":   # q, k, v in and out back: 4 all-to-alls per attention call
        assert calls["all_to_all"] == 4 * 3 and "ring_hop" not in calls
    else:                   # K and V one hop each round a ring of 2
        assert calls["ring_hop"] == 2 * 3 and "all_to_all" not in calls


def test_sp_indivisible_seq_raises(pool, reference_model):
    """The reference's ``test_sp_indivisible_seq_raises``: sp > 1 with a
    length that does not split errors, on every rank and before any
    collective, never replicating attention over sp."""
    _, state, _ = reference_model
    src = np.ones((2, 15), np.int64)   # 15 % sp(2) != 0
    with pytest.raises(ValueError, match="multiples"):
        pool.run(legs.model_forward, [("dp", 2), ("sp", 2)], "tfm", HP, state, src, src)
    assert pool.alive
