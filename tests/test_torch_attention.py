"""The port's flash attention against the JAX package's, on the CPU.

``metaopt_tpu_torch.ops.attention.flash_attention`` runs its plain PyTorch
versions here (CPU tensors); the JAX side runs the Pallas kernels in
interpret mode and the plain XLA reference. Inputs are made once with numpy
and handed to both. Bounds are those of tests/unit/test_attention.py: f32
1e-5 forward and 1e-4 gradients, bf16 3e-2.
"""

import ctypes
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.ops.attention import (
    _block_and_pad,
    _pallas_forward,
    _reference_attention,
    flash_attention as jax_flash,
)
from metaopt_tpu_torch.ops import attention as att
from metaopt_tpu_torch.utils.cuda_build import CSRC_DIR


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


KERNEL_TILE = 64  # rows and columns of flash_fwd_kernel_mma's tiles


def mma_forward_model(q, k, v, keep, skip_empty_tiles=True):
    """Test-only model of the arithmetic of ``flash_fwd_kernel_mma`` (the bf16
    K1 in csrc/flash_attention.cu), which no CPU test can run: 64-column K
    tiles; S in f32 from the bf16 operands; masked scores -1e30 and the
    running max floored at -5e29; l summed from the f32 P, and P entering
    P·V as two bf16 terms, head + tail. With ``skip_empty_tiles``, a K tile
    whose keep flags are all zero for a 64-row Q tile leaves that Q tile's
    rows untouched, as the kernel's block skips it. Returns (out bf16
    (B,Sq,H,D), lse (B,H,Sq), the number of (batch, head, Q tile, K tile)
    steps skipped)."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    b, h, sq, d = qf.shape
    sk = kf.shape[2]
    n_qt = -(-sq // KERNEL_TILE)
    m = torch.full((b, h, sq, 1), -float("inf"))
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    n_skipped = 0
    for k0 in range(0, sk, KERNEL_TILE):
        cols = slice(k0, k0 + KERNEL_TILE)
        kt = keep[:, None, :, cols]                                   # (B, 1, Sq, Bk)
        s = torch.where(kt, qf @ kf[:, :, cols].transpose(-1, -2), -1e30)
        m_new = torch.clamp_min(torch.maximum(m, s.amax(-1, keepdim=True)), -5e29)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = alpha * l + p.sum(-1, keepdim=True)
        head = p.bfloat16().float()
        acc_new = alpha * acc + (head + (p - head).bfloat16().float()) @ vf[:, :, cols]
        live = torch.ones((b, 1, sq, 1), dtype=torch.bool)
        if skip_empty_tiles:
            rows = kt.any(-1)                                         # (B, 1, Sq)
            rows = torch.nn.functional.pad(rows, (0, n_qt * KERNEL_TILE - sq))
            tiles = rows.reshape(b, 1, n_qt, KERNEL_TILE).any(-1)     # (B, 1, n_qt)
            n_skipped += h * int((~tiles).sum())
            live = tiles.repeat_interleave(KERNEL_TILE, -1)[..., :sq, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = (acc / torch.clamp_min(l, 1e-30)).bfloat16().permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), float("inf"))
    return out, lse[..., 0], n_skipped


def pallas_forward_with_lse(q, k, v, mask):
    """(out, lse) of the JAX package's Pallas forward in interpret mode, with
    ragged lengths padded to its blocks as its ``flash_attention`` pads them."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bq, sq_p = _block_and_pad(sq, 128)
    bk, sk_p = _block_and_pad(sk, 128)
    q = jnp.pad(q, ((0, 0), (0, sq_p - sq), (0, 0), (0, 0)))
    k = jnp.pad(k, ((0, 0), (0, sk_p - sk), (0, 0), (0, 0)))
    v = jnp.pad(v, ((0, 0), (0, sk_p - sk), (0, 0), (0, 0)))
    mask = jnp.pad(mask, ((0, 0), (0, sq_p - sq), (0, sk_p - sk)))
    out, lse = _pallas_forward(q, k, v, mask, bq, bk, True)
    return np.asarray(out[:, :sq], np.float32), np.asarray(lse[..., :sq])


MMA_MODEL_MASKS = ("padding", "causal", "random", "empty_rows")


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("mask_kind", MMA_MODEL_MASKS)
def test_mma_forward_model_matches_pallas(mask_kind, d):
    """The bf16 K1's numerics (P rounded to bf16, 64-column tiles, skipped
    tiles) against the Pallas forward in bf16, at a ragged multi-tile shape
    (two Q tiles, three K tiles), at the bf16 bound; and skipping fully
    masked tiles changes no bit of the result."""
    b, sq, sk, h = 2, 80, 150, 2
    arrays = make_inputs(zlib.crc32(f"mma-{mask_kind}-{d}".encode()) % 1000, b, sq, sk, h, d,
                         mask_kind)
    q, k, v, mask = to_torch(*arrays, dtype=torch.bfloat16)
    out, lse, n_skipped = mma_forward_model(q, k, v, mask)
    out_all, lse_all, none_skipped = mma_forward_model(q, k, v, mask, skip_empty_tiles=False)
    assert none_skipped == 0
    if mask_kind in ("causal", "empty_rows"):
        assert n_skipped > 0  # the skip is exercised, so the comparison below means something
    assert torch.equal(out.view(torch.int16), out_all.view(torch.int16))
    assert torch.equal(lse.view(torch.int32), lse_all.view(torch.int32))

    jout, jlse = pallas_forward_with_lse(*to_jax(*arrays, dtype=jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out.float().numpy(), jout, atol=3e-2, rtol=3e-2)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(jlse))
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(lse.numpy()[fin], jlse[fin], atol=3e-2, rtol=3e-2)


def test_mma_forward_model_feeds_the_backward_within_the_bound():
    """The chain the Transformer runs: the bf16 K1's O and lse (the model
    above) feeding the backward passes, through delta = rowsum(dO * O),
    against the same chain from the plain forward, at the slice's shape
    (B 32, S 64, H 8, D 64, causal) and the bf16 bound. dQ = dS K cancels
    (dS's rows sum to zero), so it amplifies any error in O: with P as one
    bf16 term, O moves by up to two bf16 steps and dQ leaves the bound."""
    b, s, h, d = 32, 64, 8, 64
    q, k, v, mask = to_torch(*make_inputs(21, b, s, s, h, d, "causal"), dtype=torch.bfloat16)
    m8 = mask.to(torch.int8)
    g = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (b, s, h, d)).astype(np.float32)).bfloat16()
    grads = []
    for out, lse in (mma_forward_model(q, k, v, mask)[:2], att.flash_fwd_plain(q, k, v, m8)):
        delta = att.attention_delta(g, out)
        dk, dv = att.flash_bwd_dkv_plain(q, k, v, g, lse, delta, m8)
        dq = att.flash_bwd_dq_plain(q, k, v, g, lse, delta, m8)
        grads.append((out, dq, dk, dv))
    for mine, ref in zip(*grads):
        np.testing.assert_allclose(mine.float().numpy(), ref.float().numpy(),
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


BF16_GRAD_MASKS = ("padding", "causal")


@pytest.mark.parametrize("mask_kind", BF16_GRAD_MASKS)
def test_bf16_gradients_match_pallas(mask_kind):
    """The working type: bf16 inputs, gradients in bf16, against jax.grad of
    the Pallas route in interpret mode, at the 3e-2 bound. This pins the
    plain versions, the card's oracle for K2 and K3, to the reference."""
    b, sq, sk, h, d = 2, 64, 64, 2, 64
    arrays = make_inputs(zlib.crc32(mask_kind.encode()) % 1000 + 2, b, sq, sk, h, d,
                         mask_kind)
    w = np.random.default_rng(17).standard_normal((b, sq, h, d)).astype(np.float32)

    q, k, v, mask = to_torch(*arrays, dtype=torch.bfloat16)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out = att.flash_attention(q, k, v, mask)
    (out * torch.from_numpy(w)).sum().backward()

    jq, jk, jv, jm = to_jax(*arrays, dtype=jnp.bfloat16)

    def loss(qq, kk, vv):
        o = jax_flash(qq, kk, vv, jm, impl="pallas", interpret=True)
        return jnp.sum(o * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for mine, ref in zip((q.grad, k.grad, v.grad), grads):
        assert mine.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert torch.isfinite(mine).all()
        np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                                   atol=3e-2, rtol=3e-2)


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


# ---------------------------------------------------------------------------
# the C interface of csrc/flash_attention.cu against the ctypes declarations


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _kernel_source() -> str:
    return (CSRC_DIR / "flash_attention.cu").read_text()


def _c_entry_points():
    """{name: [ctypes type of each parameter]} of the extern "C" block."""
    src = _kernel_source()
    block = src[src.index('extern "C" {'):]
    entries = {}
    for name, params in re.findall(r"\bint\s+(\w+)\(([^)]*)\)\s*\{", block):
        types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        entries[name] = [_C_TYPES[t] for t in types]
    return entries


def test_ctypes_signatures_match_the_c_entry_points():
    """A ctypes declaration with a missing or mistyped argument would pass
    pointers as 32-bit ints, which only the card would show."""
    entries = _c_entry_points()
    assert set(entries) == set(att._SIGNATURES)
    for name, argtypes in att._SIGNATURES.items():
        assert entries[name] == argtypes, name


def test_supported_pairs_match_the_kernel_dispatch():
    """Every (dtype, head dim) the wrappers accept has an instantiation."""
    cases = re.findall(r"case (\d+): return LAUNCH<(float|__nv_bfloat16), (\d+)>",
                       _kernel_source())
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    want = {(names[dt], d) for dt in att.SUPPORTED_DTYPES for d in att.SUPPORTED_HEAD_DIMS}
    assert {(t, int(d)) for _, t, d in cases} == want
    for key, t, d in cases:  # the switch key is D * 2 + is_bf16
        assert int(key) == int(d) * 2 + (t == "__nv_bfloat16")
