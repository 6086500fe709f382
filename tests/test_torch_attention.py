"""The port's flash attention against the JAX package's, on the CPU.

``metaopt_tpu_torch.ops.attention.flash_attention`` runs its plain PyTorch
versions here (CPU tensors); the JAX side runs the Pallas kernels in
interpret mode and the plain XLA reference. Inputs are made once with numpy
and handed to both. Bounds are those of tests/unit/test_attention.py: f32
1e-5 forward and 1e-4 gradients, bf16 3e-2.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.ops.attention import (
    _pallas_forward,
    _reference_attention,
    flash_attention as jax_flash,
)
from metaopt_tpu_torch.ops import attention as att


def make_inputs(seed, b, sq, sk, h, d, mask_kind):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) / np.sqrt(d)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    if mask_kind is None:
        mask = None
    elif mask_kind == "padding":
        klen = rng.integers(sk // 2, sk + 1, size=b)
        mask = np.broadcast_to(np.arange(sk)[None, None] < klen[:, None, None],
                               (b, sq, sk)).copy()
    elif mask_kind == "random":
        mask = rng.random((b, sq, sk)) < 0.7
        mask[:, :, 0] = True
    elif mask_kind == "causal":
        mask = np.broadcast_to(np.tril(np.ones((sq, sk), bool)), (b, sq, sk)).copy()
    elif mask_kind == "empty_rows":
        mask = np.broadcast_to(np.tril(np.ones((sq, sk), bool)), (b, sq, sk)).copy()
        mask[:, 3] = False
        mask[1, sq // 2:] = False
    else:
        raise ValueError(mask_kind)
    return q, k, v, mask


def to_torch(q, k, v, mask, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return t(q), t(k), t(v), None if mask is None else torch.from_numpy(mask)


def to_jax(q, k, v, mask, dtype=jnp.float32):
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            None if mask is None else jnp.asarray(mask))


FORWARD_CASES = {
    # name: (b, sq, sk, h, d, mask, block_q, block_k)
    "unmasked": (2, 16, 24, 2, 32, None, 128, 128),
    "padding_masked": (2, 16, 24, 2, 64, "padding", 128, 128),
    "random_masked": (2, 16, 24, 2, 32, "random", 128, 128),
    "causal_blocked": (2, 32, 32, 2, 32, "causal", 16, 16),
    "prime_lengths": (2, 17, 23, 2, 32, "padding", 128, 128),
    "ragged_multiblock": (2, 40, 33, 2, 32, "random", 16, 16),
    "multiblock_k16": (1, 8, 64, 2, 128, None, 128, 16),
    "fully_masked_rows": (2, 20, 20, 2, 32, "empty_rows", 128, 128),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_matches_pallas_and_reference(name):
    b, sq, sk, h, d, mask_kind, bq, bk = FORWARD_CASES[name]
    arrays = make_inputs(zlib.crc32(name.encode()) % 1000, b, sq, sk, h, d, mask_kind)
    out = att.flash_attention(*to_torch(*arrays), block_q=bq, block_k=bk)
    jq, jk, jv, jm = to_jax(*arrays)
    pallas = jax_flash(jq, jk, jv, jm, impl="pallas", interpret=True,
                       block_q=bq, block_k=bk)
    ref = _reference_attention(jq, jk, jv, jm)
    assert out.shape == (b, sq, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fully_masked_rows_give_zero_output_and_inf_lse():
    q, k, v, mask = to_torch(*make_inputs(5, 2, 20, 20, 2, 32, "empty_rows"))
    out, lse = att.flash_fwd(q, k, v, mask.to(torch.int8))
    empty = ~mask.any(-1)                                    # (b, sq)
    assert empty.any()
    assert torch.isfinite(out).all()
    assert (out[empty] == 0).all()
    assert torch.isinf(lse.permute(0, 2, 1)[empty]).all()
    assert torch.isfinite(lse.permute(0, 2, 1)[~empty]).all()


def test_lse_matches_pallas_forward():
    arrays = make_inputs(6, 2, 32, 32, 2, 32, "empty_rows")
    q, k, v, mask = to_torch(*arrays)
    _, lse = att.flash_fwd(q, k, v, mask.to(torch.int8), block_k=16)
    jq, jk, jv, jm = to_jax(*arrays)
    _, jlse = _pallas_forward(jq, jk, jv, jm, 16, 16, True)
    jlse = np.asarray(jlse)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(jlse))
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(lse.numpy()[fin], jlse[fin], atol=1e-5, rtol=1e-5)


def test_bf16_io_matches_pallas():
    arrays = make_inputs(7, 2, 16, 24, 2, 32, "padding")
    out = att.flash_attention(*to_torch(*arrays, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    jq, jk, jv, jm = to_jax(*arrays, dtype=jnp.bfloat16)
    pallas = jax_flash(jq, jk, jv, jm, impl="pallas", interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                               atol=3e-2, rtol=3e-2)


GRAD_CASES = {
    "causal_blocked": (2, 32, 32, 2, 32, "causal", 16, 16),
    "ragged_fully_masked": (2, 21, 19, 2, 32, "empty_rows", 8, 8),
    "prime_padding": (1, 17, 23, 2, 64, "padding", 128, 128),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_pallas(name):
    b, sq, sk, h, d, mask_kind, bq, bk = GRAD_CASES[name]
    arrays = make_inputs(zlib.crc32(name.encode()) % 1000 + 1, b, sq, sk, h, d, mask_kind)
    w = np.random.default_rng(11).standard_normal((b, sq, h, d)).astype(np.float32)

    q, k, v, mask = to_torch(*arrays)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out = att.flash_attention(q, k, v, mask, block_q=bq, block_k=bk)
    (out * torch.from_numpy(w)).sum().backward()

    jq, jk, jv, jm = to_jax(*arrays)

    def loss(qq, kk, vv):
        o = jax_flash(qq, kk, vv, jm, impl="pallas", interpret=True,
                      block_q=bq, block_k=bk)
        return jnp.sum(o * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for mine, ref in zip((q.grad, k.grad, v.grad), grads):
        assert torch.isfinite(mine).all()
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_plain_backward_passes_match_autograd_of_reference():
    """K2 and K3's plain versions, called directly, against autograd of the
    plain O(S²) attention."""
    q, k, v, mask = to_torch(*make_inputs(12, 2, 24, 40, 2, 32, "random"))
    m8 = mask.to(torch.int8)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 24, 2, 32)).astype(np.float32))
    out, lse = att.flash_fwd_plain(q, k, v, m8, block_k=16)
    delta = att.attention_delta(g, out)
    dk, dv = att.flash_bwd_dkv_plain(q, k, v, g, lse, delta, m8, block_q=8)
    dq = att.flash_bwd_dq_plain(q, k, v, g, lse, delta, m8, block_k=16)

    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    (att.reference_attention(qr, kr, vr, m8) * g).sum().backward()
    for mine, ref in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def test_dropout_raises_not_implemented():
    q, k, v, _ = to_torch(*make_inputs(8, 1, 8, 8, 1, 32, None))
    with pytest.raises(NotImplementedError, match="chunked dropout twin"):
        att.flash_attention(q, k, v, dropout_rate=0.1)


@pytest.mark.parametrize("d", [8, 16, 48, 256])
def test_unsupported_head_dim_raises(d):
    q, k, v, _ = to_torch(*make_inputs(9, 1, 8, 8, 1, d, None))
    with pytest.raises(ValueError, match="head dim"):
        att.flash_attention(q, k, v)


def test_unsupported_dtype_raises():
    q, k, v, _ = to_torch(*make_inputs(10, 1, 8, 8, 1, 32, None), dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        att.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["g_shape", "g_dtype", "lse_shape", "delta_shape"])
def test_backward_wrappers_reject_mismatched_inputs(bad):
    q, k, v, _ = to_torch(*make_inputs(14, 1, 8, 8, 2, 32, None))
    g = torch.ones_like(q)
    out, lse = att.flash_fwd(q, k, v)
    delta = att.attention_delta(g, out)
    if bad == "g_shape":
        g = g[:, :4]
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "lse_shape":
        lse = lse[..., :4]
    else:
        delta = delta.transpose(1, 2)
    for fn in (att.flash_bwd_dkv, att.flash_bwd_dq):
        with pytest.raises(ValueError, match="must"):
            fn(q, k, v, g, lse, delta)


def test_cpu_wrappers_do_not_count_kernel_launches():
    att.reset_launch_counts()
    q, k, v, mask = to_torch(*make_inputs(13, 1, 8, 8, 2, 32, "causal"))
    q.requires_grad_()
    att.flash_attention(q, k, v, mask).sum().backward()
    assert att.launches == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
