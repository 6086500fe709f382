"""The port's blocked softmax cross-entropy against the JAX package's, on the CPU.

``metaopt_tpu_torch.ops.xent`` against ``metaopt_tpu.ops.xent`` and the
dense ``lse − label logit`` in f32, on the same numpy inputs: values at
``block_v`` 8, 32 and 96 within 1e-5, both gradients within 1e-4 relative
and 1e-5 absolute (the reference's own bounds, ``tests/unit/test_xent.py``),
bf16 inputs within 0.05 of the f32 oracle, ``pick_block_v`` equal, and the
losses' routing by per-device logits bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.ops import xent as jx
from metaopt_tpu_torch.models import transformer as tt
from metaopt_tpu_torch.ops import xent as tx


def data(n=24, d=16, v=96, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, d)).astype(np.float32)
    emb = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, n)
    return y, emb, labels


def dense_xent(y, emb, labels):
    logits = y.float() @ emb.float().t()
    return torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]


@pytest.mark.parametrize("block_v", [8, 32, 96])
def test_values_match_dense_and_the_reference(block_v):
    y, emb, labels = data()
    got = tx.blocked_softmax_xent(torch.from_numpy(y), torch.from_numpy(emb),
                                  torch.from_numpy(labels), block_v)
    assert got.dtype == torch.float32 and got.shape == (24,)
    want = dense_xent(torch.from_numpy(y), torch.from_numpy(emb), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    ref = np.asarray(jx.blocked_softmax_xent(jnp.asarray(y), jnp.asarray(emb),
                                             jnp.asarray(labels), block_v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_v", [16, 32])
def test_gradients_match_dense_and_the_reference(block_v):
    y, emb, labels = data(v=64 if block_v == 16 else 96, seed=1)
    lab = torch.from_numpy(labels)
    ty, te = (torch.from_numpy(a).requires_grad_() for a in (y, emb))
    (tx.blocked_softmax_xent(ty, te, lab, block_v) * 0.7).sum().backward()
    dy, de = (torch.from_numpy(a).requires_grad_() for a in (y, emb))
    (dense_xent(dy, de, lab) * 0.7).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), dy.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), de.grad.numpy(), rtol=1e-4, atol=1e-5)

    gy, ge = jax.grad(lambda a, b: jnp.sum(jx.blocked_softmax_xent(
        a, b, jnp.asarray(labels), block_v) * 0.7), argnums=(0, 1))(
        jnp.asarray(y), jnp.asarray(emb))
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), rtol=1e-4, atol=1e-5)


def test_bf16_inputs_close_to_the_f32_oracle_and_equal_to_the_reference():
    """bf16 features and table: the products are f32 (exact products of
    bf16 values, f32 accumulation), as the reference's
    ``preferred_element_type=f32``; the gradients come back in bf16."""
    y, emb, labels = data()
    lab = torch.from_numpy(labels)
    by, be = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (y, emb))
    got = tx.blocked_softmax_xent(by, be, lab, 32)
    want = dense_xent(torch.from_numpy(y), torch.from_numpy(emb), lab)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0.05, atol=0.05)
    # against the reference on the same bf16 values: both accumulate in f32
    ref = np.asarray(jx.blocked_softmax_xent(jnp.asarray(y, jnp.bfloat16),
                                             jnp.asarray(emb, jnp.bfloat16),
                                             jnp.asarray(labels), 32))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert by.grad.dtype == torch.bfloat16 and be.grad.dtype == torch.bfloat16


def test_labels_in_every_block_and_a_one_block_vocab():
    y, emb, _ = data(n=32, v=64, seed=2)
    labels = np.arange(32) * 2          # two labels per block of 8
    t = [torch.from_numpy(a) for a in (y, emb, labels)]
    want = dense_xent(*t).numpy()
    for block_v in (8, 64):
        got = tx.blocked_softmax_xent(t[0], t[1], t[2], block_v).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_a_block_that_does_not_divide_the_vocab_raises():
    y, emb, labels = (torch.from_numpy(a) for a in data())
    with pytest.raises(ValueError, match="divide"):
        tx.blocked_softmax_xent(y, emb, labels, 40)


@pytest.mark.parametrize("vocab,target", [(32000, 4096), (96, 40), (9973, 4096),
                                          (1000, 4096), (32768, 4096), (50257, 4096),
                                          (64, 4096)])
def test_pick_block_v_matches_the_reference(vocab, target):
    got = tx.pick_block_v(vocab, target)
    assert got == jx.pick_block_v(vocab, target)
    assert vocab % got == 0


def test_pick_block_v_values():
    assert tx.pick_block_v(32000) == 4000
    assert tx.pick_block_v(96, target=40) == 32
    assert tx.pick_block_v(9973) == 9973   # a prime: one whole-vocab block


@pytest.mark.parametrize("batch,seq,vocab,shards", [
    (64, 512, 32768, 1), (64, 512, 32768, 2), (32, 512, 1000, 1), (64, 256, 32000, 1),
    (128, 256, 32768, 1), (64, 16, 1000, 8),
])
def test_the_gate_matches_the_reference_by_per_device_bytes(batch, seq, vocab, shards):
    from metaopt_tpu.models import transformer as jt

    assert tt.blocked_xent_enabled(batch, seq, vocab, shards) == \
        jt.blocked_xent_enabled(batch, seq, vocab, shards)
    assert tt._BLOCKED_XENT_MIN_LOGITS_BYTES == jt._BLOCKED_XENT_MIN_LOGITS_BYTES == 4 << 30


def test_the_gate_is_per_device_bytes(monkeypatch):
    monkeypatch.setattr(tt, "_BLOCKED_XENT_MIN_LOGITS_BYTES", 4 * 64 * 16 * 1000)
    assert tt.blocked_xent_enabled(64, 16, 1000)
    assert not tt.blocked_xent_enabled(64, 16, 1000, shards=8)
    # the LM's route at the card's vocab-32768 step: exactly 4 GiB of logits
    monkeypatch.undo()
    assert tt.blocked_xent_enabled(64, 512, 32768)
    assert not tt.blocked_xent_enabled(63, 512, 32768)
