"""The port's pipeline schedules against the JAX package's, on CPU ranks.

Restates ``tests/unit/test_pipeline.py`` on four CPU ranks (one pool for
the file; the reference's 8-device meshes become pp × dp meshes of 4): the
same numpy stage stack and batch through the reference's
``pipeline_apply`` (a CPU mesh of the same shape) or its sequential oracle,
and through the port's, each rank holding its dp rows; GPipe and the
interleaved schedule, the ends (embedding and readout), gradients (the
whole stack's: each rank's summed over pp and dp), ``bubble_fraction``,
the errors, and the pipeline LM against the reference's
``reference_forward`` on the reference's own weights. Bounds: f32 1e-5
(1e-4 relative for gradients through the ends, as the reference holds
them); the LM's bf16 trunk 5e-3, the reference's own bound (measured
1.3e-6 against the reference's sequential stack); the pp train step's
gradients against the same loss through the sequential stack within the
bf16 bound, 3e-2 of each tensor's scale (measured 3.8e-3: a microbatch's
bf16 products round differently from the whole batch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_legs as legs
from metaopt_tpu.models import pipeline_lm as jplm
from metaopt_tpu.parallel import pipeline as jpipe
from metaopt_tpu.parallel.mesh import make_mesh as jmake_mesh
from metaopt_tpu_torch.models import pipeline_lm as plm
from metaopt_tpu_torch.parallel.launch import RankPool
from metaopt_tpu_torch.parallel.pipeline import bubble_fraction

CALL_S = 60


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=CALL_S) as p:
        yield p


def stacked(seed, n, d):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    return w, b


def sequential(w, b, x):
    for i in range(w.shape[0]):
        x = np.tanh(x @ w[i] + b[i])
    return x


def rows(parts, axes):
    """The global batch from the ranks' dp rows (pp ranks hold the same)."""
    sizes = dict(axes)
    names = [a for a, _ in axes]
    by_dp = {}
    for r, part in enumerate(parts):
        idx = dict(zip(names, np.unravel_index(r, [n for _, n in axes])))
        by_dp.setdefault(int(idx.get("dp", 0)), part)
    return np.concatenate([by_dp[i]["y"].numpy() for i in range(sizes.get("dp", 1))], 0)


@pytest.mark.parametrize("pp,dp", [(4, 1), (2, 2)])
def test_matches_sequential(pool, pp, dp):
    axes = [("pp", pp), ("dp", dp)]
    w, b = stacked(0, pp, 8)
    x = np.random.default_rng(1).standard_normal((4 * dp * pp, 8)).astype(np.float32)
    parts = pool.run(legs.pipe, axes, w, b, x)
    y = rows(parts, axes)
    np.testing.assert_allclose(y, sequential(w, b, x), atol=1e-5, rtol=1e-5)
    # every pp rank returns the outputs
    np.testing.assert_array_equal(parts[0]["y"].numpy(), parts[dp]["y"].numpy())
    if (pp, dp) == (2, 2):   # the reference's on a CPU mesh of the same shape
        mesh = jmake_mesh(axes, devices=jax.devices()[:4])
        want = jpipe.pipeline_apply(lambda p, h: jnp.tanh(h @ p[0] + p[1]),
                                    (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x), mesh=mesh)
        np.testing.assert_allclose(y, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_more_microbatches_than_stages(pool):
    axes = [("pp", 2), ("dp", 2)]
    w, b = stacked(2, 2, 8)
    x = np.random.default_rng(3).standard_normal((32, 8)).astype(np.float32)
    y = rows(pool.run(legs.pipe, axes, w, b, x, False, n_microbatches=8), axes)
    np.testing.assert_allclose(y, sequential(w, b, x), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(), "multiple"),
    (dict(n_microbatches=6, virtual_stages=2), "groups of 4"),
], ids=["indivisible-microbatch", "microbatch-groups"])
def test_errors(pool, kw, match):
    axes = [("pp", 4)]
    v = kw.get("virtual_stages", 1)
    w, b = stacked(4, 4 * v, 4)
    x = np.ones((6 if not kw else 12, 4), np.float32)
    assert all(match in e for e in pool.run(legs.pipe_error, axes, w, b, x, **kw))
    mesh = jmake_mesh([("pp", 4)], devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=match):
        jpipe.pipeline_apply(lambda p, h: h, (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x),
                             mesh=mesh, **kw)


def test_missing_axis_raises(pool):
    w, b = stacked(5, 4, 4)
    assert all("pp" in e for e in pool.run(legs.pipe_error, [("dp", 4)], w, b,
                                           np.ones((8, 4), np.float32)))


def test_grads_match_sequential(pool):
    axes = [("pp", 2), ("dp", 2)]
    w, b = stacked(6, 2, 8)
    x = np.random.default_rng(7).standard_normal((16, 8)).astype(np.float32)
    parts = pool.run(legs.pipe, axes, w, b, x, True)
    want = jax.grad(lambda p: jnp.sum(
        _jsequential(p[0], p[1], jnp.asarray(x)) ** 2))((jnp.asarray(w), jnp.asarray(b)))
    for r in range(4):   # every rank holds the whole stack's gradients
        for got, exp in zip(parts[r]["grads"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


def _jsequential(w, b, x):
    for i in range(w.shape[0]):
        x = jnp.tanh(x @ w[i] + b[i])
    return x


@pytest.mark.parametrize("pp,v,m_mult", [(2, 2, 1), (4, 2, 1), (2, 4, 3)])
def test_virtual_stages_match_sequential(pool, pp, v, m_mult):
    dp = 4 // pp
    axes = [("pp", pp), ("dp", dp)]
    w, b = stacked(2, pp * v, 8)
    m = pp * m_mult
    x = np.random.default_rng(3).standard_normal((2 * dp * m, 8)).astype(np.float32)
    y = rows(pool.run(legs.pipe, axes, w, b, x, False, n_microbatches=m, virtual_stages=v),
             axes)
    np.testing.assert_allclose(y, sequential(w, b, x), atol=1e-5, rtol=1e-5)


def test_interleaved_grads_match_sequential(pool):
    axes = [("pp", 2), ("dp", 2)]
    w, b = stacked(4, 4, 8)
    x = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    parts = pool.run(legs.pipe, axes, w, b, x, True, n_microbatches=4, virtual_stages=2)
    want = jax.grad(lambda p: jnp.sum(
        _jsequential(p[0], p[1], jnp.asarray(x)) ** 2))((jnp.asarray(w), jnp.asarray(b)))
    for got, exp in zip(parts[0]["grads"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-4)


def test_bubble_fraction_equals_the_references():
    for args in ((4, 8, 1), (4, 8, 2), (2, 3, 4), (8, 16, 1)):
        assert bubble_fraction(*args) == jpipe.bubble_fraction(*args)
    assert bubble_fraction(4, 8, 1) == pytest.approx(3 / 11)
    assert bubble_fraction(4, 8, 2) == pytest.approx(3 / 19)


def test_embed_blocks_readout_and_their_grads(pool):
    """The ends: int tokens → embedding (pre) → P·V stages → readout (post),
    and the gradients of all three."""
    pp, v, d, vocab = 2, 2, 8, 17
    axes = [("pp", pp), ("dp", 2)]
    w, b = stacked(8, pp * v, d)
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((vocab, d)).astype(np.float32)
    ro = rng.standard_normal((d, vocab)).astype(np.float32)
    toks = rng.integers(0, vocab, (16, 5))
    parts = pool.run(legs.pipe, axes, w, b, toks, True, n_microbatches=4, virtual_stages=v,
                     pre_params=emb, post_params=ro)
    y = rows(parts, axes)
    assert y.shape == (16, 5, vocab)
    np.testing.assert_allclose(y, sequential(w, b, emb[toks]) @ ro, atol=1e-5, rtol=1e-4)

    def loss(w, b, emb, ro):
        return jnp.sum((_jsequential(w, b, emb[toks]) @ ro) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (w, b, emb, ro)))
    for got, exp in zip(parts[0]["grads"], want):
        scale = np.abs(np.asarray(exp)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5 * scale, rtol=1e-4)


@pytest.fixture(scope="module")
def reference_lm():
    """The reference's pipeline LM (one head of 64: the port keeps q in bf16,
    exact when sqrt(d_head) is a power of two), its stage init under
    ``jax.jit`` (the same values; eager vmap of the flax init takes ~15 s)."""
    hp = {"d_model": 64, "n_heads": 1, "d_ff": 64, "vocab": 61}
    vmap = jax.vmap
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "vmap", lambda f, *a, **k: jax.jit(vmap(f, *a, **k)))
        fns, params = jplm.make_pipeline_lm(hp, n_stages=2, virtual_stages=2, seq=8)
    toks = np.random.default_rng(1).integers(1, 61, (8, 8))
    want = np.asarray(jax.jit(lambda p, x: jplm.reference_forward(fns, p, x))(
        params, jnp.asarray(toks)))
    mine = plm.params_from_flax_pipeline(jax.tree.map(np.asarray, params))
    return hp, mine, toks, want


def test_pipeline_lm_matches_the_references_forward(pool, reference_lm):
    """The port's EncoderLayer stages under the interleaved schedule on the
    reference's weights against the reference's sequential stack."""
    hp, params, toks, want = reference_lm
    axes = [("pp", 2), ("dp", 2)]
    parts = pool.run(legs.pipe_lm, axes, hp, params, toks, 4, 2)
    got = np.concatenate([parts[0].numpy(), parts[1].numpy()], 0)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)   # bf16 trunk
    seq = plm.reference_forward(plm.stage_fns(hp, "cpu"), params, torch.as_tensor(toks))
    np.testing.assert_allclose(seq.detach().numpy(), want, atol=5e-3, rtol=5e-3)


def test_pp_train_step_matches_sequential_gradients(pool, reference_lm):
    """``make_pp_train_step`` at pp 2 × V 2: loss and every gradient against
    the same loss through ``reference_forward`` (one process), and finite
    and nonzero at the pipe's ends."""
    hp, params, toks, _ = reference_lm
    parts = pool.run(legs.pipe_lm, [("pp", 2), ("dp", 2)], hp, params, toks, 4, 2, True)
    loss, grads = parts[0]
    leaves = [t.clone().requires_grad_(True) for t in plm.tree_leaves(params)]
    it = iter(leaves)
    tree = plm.tree_map(lambda _: next(it), params)
    logits = plm.reference_forward(plm.stage_fns(hp, "cpu"), tree, torch.as_tensor(toks))
    want = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 61),
                                             torch.as_tensor(toks)[:, 1:].reshape(-1))
    want.backward()
    assert loss == pytest.approx(float(want), rel=1e-5)
    worst = 0.0
    for got, t in zip(plm.tree_leaves(grads), leaves):
        scale = float(t.grad.abs().max())
        worst = max(worst, float((got - t.grad).abs().max()) / scale)
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=3e-2 * scale, rtol=3e-2)
    print(f"pp step gradients: worst |pp - sequential| / scale = {worst:.2e}")
    assert all(float(g.abs().sum()) > 0 for g in plm.tree_leaves(grads[1:]))


def test_a_tp_step_and_a_pp_step_import_no_dynamo(pool):
    """The ranks (spawned interpreters that import only torch, the port and
    the legs) run a tp 2 Transformer train step at dropout 0.1 and a pp 2 ×
    V 2 pipeline LM step: none has imported ``torch._dynamo`` (~11 s a
    process on the card's host)."""
    assert pool.run(legs.no_dynamo_steps) == [False] * 4
