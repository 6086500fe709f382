"""The port's ring attention against the JAX package's, on CPU ranks.

Restates ``tests/unit/test_ring_attention.py`` on four CPU ranks (one pool
for the file): the same numpy inputs go through the reference's
``ring_attention`` on a CPU mesh of the same shape and through the port's
on the ranks, each rank taking its (dp rows, sp positions, tp heads)
slices; the parent reassembles the outputs (and the gradients of
sum(out²)). Where compiling the reference's ring for each shape would
cost more than the file's time, the reference's oracle
(``_reference_attention``, which its own ring test holds the ring to)
stands in. Bounds: f32 1e-5 forward and 1e-4 for gradients, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_legs as legs
from metaopt_tpu.ops.attention import _reference_attention
from metaopt_tpu.ops.ring_attention import ring_attention as jring
from metaopt_tpu.parallel.mesh import make_mesh as jmake_mesh
from metaopt_tpu_torch.parallel.launch import RankPool

CALL_S = 60


@pytest.fixture(scope="module")
def pool():
    with RankPool(["cpu"] * 4, timeout_s=CALL_S) as p:
        yield p


def qkv(seed, b=2, s=32, h=2, d=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


def assemble(parts, axes, key):
    """The global (B, S, H, D) tensor from each rank's (dp, sp, tp) slice."""
    sizes = dict(axes)
    dp, sp, tp = (sizes.get(a, 1) for a in ("dp", "sp", "tp"))
    names = [a for a, _ in axes]
    grid = {}
    for r, part in enumerate(parts):
        idx = np.unravel_index(r, [n for _, n in axes])
        c = {a: i for a, i in zip(names, idx)}
        grid[(c.get("dp", 0), c.get("sp", 0), c.get("tp", 0))] = np.asarray(
            part[key].float().numpy() if hasattr(part[key], "float") else part[key])
    rows = [np.concatenate([np.concatenate([grid[(i, j, t)] for t in range(tp)], 2)
                            for j in range(sp)], 1) for i in range(dp)]
    return np.concatenate(rows, 0)


def reference(axes, q, k, v, mask=None):
    mesh = jmake_mesh(axes, devices=jax.devices()[:4])
    return np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask), mesh=mesh),
                      np.float32)


@pytest.mark.parametrize("sp", [2, 4])
def test_matches_reference_unmasked(pool, sp):
    axes = [("sp", sp), ("dp", 4 // sp)]
    q, k, v = qkv(0, b=4 // sp * 2, s=8 * sp)
    out = assemble(pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False), axes, "out")
    if sp == 2:   # the reference's ring on a CPU mesh of the same shape
        np.testing.assert_allclose(out, reference(axes, q, k, v), atol=1e-5, rtol=1e-5)
    oracle = np.asarray(_reference_attention(q, k, v, None))
    np.testing.assert_allclose(out, oracle, atol=1e-5, rtol=1e-5)


def causal(b, s):
    return np.broadcast_to(np.tril(np.ones((s, s), bool))[None], (b, s, s)).copy()


def test_causal_mask(pool):
    axes = [("sp", 4)]
    q, k, v = qkv(1, b=2, s=32)
    m = causal(2, 32)
    out = assemble(pool.run(legs.sp_attention, axes, "ring", q, k, v, m, False), axes, "out")
    np.testing.assert_allclose(out, np.asarray(_reference_attention(q, k, v, m)), atol=1e-5,
                               rtol=1e-5)


def test_pad_mask_with_fully_masked_rows(pool):
    axes = [("sp", 2), ("dp", 2)]
    s = 16
    q, k, v = qkv(2, b=2, s=s)
    mask = np.zeros((2, s, s), bool)
    mask[:, :, :4] = True
    mask[:, 8:] = False   # rows 8.. attend to nothing
    out = assemble(pool.run(legs.sp_attention, axes, "ring", q, k, v, mask, False), axes,
                   "out")
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, reference(axes, q, k, v, mask), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, 8:], 0.0, atol=1e-6)


@pytest.mark.parametrize("axes", [[("dp", 2), ("sp", 2)], [("sp", 2), ("tp", 2)]],
                         ids=["dp2-sp2", "sp2-tp2"])
def test_composes_with_tp_and_dp(pool, axes):
    q, k, v = qkv(3, b=4, s=16, h=4, d=4)
    out = assemble(pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False), axes, "out")
    np.testing.assert_allclose(out, np.asarray(_reference_attention(q, k, v, None)), atol=1e-5,
                               rtol=1e-5)


def test_bf16_io(pool):
    import ml_dtypes
    import torch

    axes = [("sp", 4)]
    q, k, v = (t.astype(ml_dtypes.bfloat16) for t in qkv(4, b=2, s=16))
    parts = pool.run(legs.sp_attention, axes, "ring",
                     *(torch.from_numpy(t.astype(np.float32)).bfloat16() for t in (q, k, v)),
                     None, False)
    assert all(p["out"].dtype == torch.bfloat16 for p in parts)
    np.testing.assert_allclose(assemble(parts, axes, "out"), reference(axes, q, k, v),
                               atol=3e-2, rtol=3e-2)


def test_seq_not_divisible_raises(pool):
    q, _, _ = qkv(5, b=1, s=12)
    errs = pool.run(legs.sp_error, [("sp", 4)], "slice", q[:, :10])
    assert all("divide" in e for e in errs)
    with pytest.raises(ValueError, match="divide"):
        jring(*(jnp.asarray(q),) * 3, mesh=jmake_mesh([("sp", 8)]))


def test_grads_match_reference(pool):
    """Against the gradients of the reference's oracle (its own ring test
    holds its ring's gradients to the same; differentiating its shard_map
    here would spend ~20 s compiling)."""
    axes = [("sp", 2), ("dp", 2)]
    s = 16
    q, k, v = qkv(6, b=2, s=s, h=1, d=4)
    m = causal(2, s)
    parts = pool.run(legs.sp_attention, axes, "ring", q, k, v, m, True)

    def loss(q, k, v):
        return jnp.sum(_reference_attention(q, k, v, jnp.asarray(m)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    for key, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(assemble(parts, axes, key), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_dropout_on_given_bits_matches_the_oracle(pool):
    """Rate 0.3 on given keep bits: each rank folds its slices of the same
    (B, H, Sq, Sk) bits; the result is dropout(softmax) @ V on the whole."""
    axes = [("sp", 4)]
    q, k, v = qkv(7, b=2, s=16, h=2, d=4)
    keep = np.random.default_rng(8).random((2, 2, 16, 16)) < 0.7
    parts = pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False, None, (0.3, keep))
    out = assemble(parts, axes, "out")
    s = np.einsum("bqhd,bkhd->bhqk", q, k)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    p = np.where(keep, p / np.float32(0.7), 0.0)
    np.testing.assert_allclose(out, np.einsum("bhqk,bkhd->bqhd", p, v), atol=1e-5, rtol=1e-5)


def test_dropout_deterministic_and_trainable(pool):
    axes = [("sp", 2), ("dp", 2)]
    q, k, v = qkv(8, b=2, s=16, h=1, d=4)
    a = pool.run(legs.sp_attention, axes, "ring", q, k, v, None, True, (0.3, (9, 0)))
    b = pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False, (0.3, (9, 0)))
    c = pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False, (0.3, (10, 0)))
    oa, ob, oc = (assemble(x, axes, "out") for x in (a, b, c))
    np.testing.assert_array_equal(oa, ob)
    assert not np.allclose(oa, oc)
    for key in ("dq", "dk", "dv"):
        assert np.isfinite(assemble(a, axes, key)).all()
    # the kept share of the probabilities is the keep rate
    zero = assemble(pool.run(legs.sp_attention, axes, "ring", q, k, v, None, False), axes,
                    "out")
    assert not np.allclose(oa, zero)


def test_sharded_flash_attention_matches_the_oracle(pool):
    """``sharded_flash_attention`` on dp 2 × tp 2: each rank's (B/dp, S,
    H/tp, D) slab through the port's ``flash_attention`` (the plain
    versions of K1–K3 here), no collective; with dropout, each (dp, tp)
    coordinate draws from its own Philox seed."""
    from metaopt_tpu_torch.ops.attention import shard_philox

    axes = [("dp", 2), ("tp", 2)]
    q, k, v = qkv(9, b=4, s=16, h=4, d=32)
    m = causal(4, 16)
    parts = pool.run(legs.sharded_attention, axes, q, k, v, m, None)
    out = np.concatenate([np.concatenate([parts[2 * i + j].numpy() for j in range(2)], 2)
                          for i in range(2)], 0)
    np.testing.assert_allclose(out, np.asarray(_reference_attention(q, k, v, m)), atol=1e-5,
                               rtol=1e-5)
    seeds = {shard_philox((7, 3), c) for c in ((0, 0), (0, 1), (1, 0), (1, 1))}
    assert len(seeds) == 4 and all(off == 3 for _, off in seeds)
    dropped = pool.run(legs.sharded_attention, axes, q, k, v, m, (7, 3))
    assert all(np.isfinite(d.numpy()).all() for d in dropped)
    assert not np.allclose(dropped[0].numpy(), parts[0].numpy())
