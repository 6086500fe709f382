"""Attention dropout in the port's flash attention, on the CPU.

The kernels K1–K3 draw their keep bits in registers with Philox4x32-10;
their plain versions (what runs here, on CPU tensors) draw the same bits
through ``philox_keep``. Three things are held here:

- the arithmetic: the plain versions fed the reference's own threefry bits
  (``_dropout_tile`` of ``metaopt_tpu/ops/attention.py``, concatenated over
  the K blocks) against ``jax.vjp`` of the reference's chunked twin, f32
  1e-5 forward and 1e-4 for gradients;
- the bits: Philox4x32-10's known-answer vectors (Random123's
  ``kat_vectors``), the counter layout the kernels use, determinism,
  independence across offsets and the kept fraction;
- the statistics: E[O] over many seeds against attention without dropout,
  and autograd replaying the forward's bits in the backward.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.ops.attention import _block_and_pad, _dropout_tile
from metaopt_tpu.ops.attention import flash_attention as jax_flash
from metaopt_tpu_torch.ops import attention as att

M32 = 0xFFFFFFFF


def make_inputs(seed, b, sq, sk, h, d, mask_kind):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    if mask_kind == "padding":
        klen = rng.integers(sk // 2, sk + 1, size=b)
        mask = np.broadcast_to(np.arange(sk)[None, None] < klen[:, None, None],
                               (b, sq, sk)).copy()
    elif mask_kind == "causal":
        mask = np.broadcast_to(np.tril(np.ones((sq, sk), bool)), (b, sq, sk)).copy()
    else:
        mask = None
    return q, k, v, g, mask


def reference_bits(key, rate, b, h, sq, sk, block_q, block_k):
    """The chunked twin's keep bits, (b, h, sq, sk): ``_dropout_tile`` of
    each K block over the padded shape, cut to the real one."""
    _, sq_p = _block_and_pad(sq, block_q)
    bk, sk_p = _block_and_pad(sk, block_k)
    tiles = [np.asarray(_dropout_tile(key, i, 1.0 - rate, (b, h, sq_p, bk)))
             for i in range(sk_p // bk)]
    return np.concatenate(tiles, -1)[:, :, :sq, :sk]


PARITY_CASES = {
    # name: (b, sq, sk, h, d, mask, block): sk = 40 pads to 48 in the reference
    "padding-ragged": (2, 48, 40, 2, 32, "padding", 16),
    "causal": (2, 32, 32, 2, 32, "causal", 16),
    "unmasked-one-block": (1, 24, 24, 2, 64, None, 128),
}


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_plain_dropout_matches_the_reference_chunked_twin_on_its_bits(name, rate):
    b, sq, sk, h, d, mask_kind, block = PARITY_CASES[name]
    q, k, v, g, mask = make_inputs(zlib.crc32(name.encode()) % 1000, b, sq, sk, h, d,
                                   mask_kind)
    key = jax.random.PRNGKey(7)
    keep = torch.from_numpy(reference_bits(key, rate, b, h, sq, sk, block, block))
    assert 0.5 < float(keep.float().mean()) < 0.95

    jm = None if mask is None else jnp.asarray(mask)

    def ref(jq, jk, jv):
        return jax_flash(jq, jk, jv, jm, dropout_rate=rate, dropout_key=key,
                         block_q=block, block_k=block, impl="chunked")

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    m8 = None if mask is None else torch.from_numpy(mask).to(torch.int8)
    drop = dict(dropout_rate=rate, keep=keep)
    out, lse = att.flash_fwd_plain(tq, tk, tv, m8, block_k=block, **drop)
    delta = att.attention_delta(tg, out)
    dk, dv = att.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta, m8, block_q=block, **drop)
    dq = att.flash_bwd_dq_plain(tq, tk, tv, tg, lse, delta, m8, block_k=block, **drop)

    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    for mine, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_dropout_moves_the_output():
    """The parity above is not a comparison of two dropout-free passes."""
    q, k, v, g, mask = make_inputs(3, 1, 16, 16, 2, 32, None)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain, _ = att.flash_fwd_plain(tq, tk, tv)
    dropped, _ = att.flash_fwd_plain(tq, tk, tv, dropout_rate=0.3, seed=5, offset=0)
    assert float((plain - dropped).abs().max()) > 0.05


# ---------------------------------------------------------------------------
# the Philox keep bits


def _philox_scalar(ctr, key):
    """Philox4x32-10 in Python integers: a second, independent statement."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & M32, p1 & M32, ((p0 >> 32) ^ c[3] ^ k1) & M32,
             p0 & M32]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zero", "ones", "pi"])
def test_philox4x32_10_known_answers(ctr, key, want):
    got = att.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_scalar(ctr, key)) == want


def test_keep_bits_follow_the_kernels_counter_layout():
    """Element (b·h, row, col) is word col % 4 of Philox on the counter
    (col // 4, row, b·h, offset), keyed by the seed's two 32-bit halves, kept
    below keep_prob · 2³² — the layout csrc/flash_attention.cu draws."""
    seed, offset, rate = 0x0123456789ABCDEF, 4242, 0.3
    bh, rows, cols = [0, 3, 17], list(range(5, 12)), list(range(0, 70, 3))
    bits = att.philox_keep(seed, offset, bh, rows, cols, rate)
    assert bits.shape == (3, 7, len(cols)) and bits.dtype == torch.bool
    thr = att.keep_threshold(rate)
    assert thr == int(np.float32(np.float32(1.0) - np.float32(rate)) * 2 ** 32)
    for i, z in enumerate(bh):
        for j, r in enumerate(rows):
            for n, c in enumerate(cols):
                words = _philox_scalar((c // 4, r, z, offset), (seed & M32, seed >> 32))
                assert bool(bits[i, j, n]) == (words[c % 4] < thr), (z, r, c)


def test_same_seed_and_offset_give_the_same_bits():
    a = att.philox_keep(99, 3, range(4), range(32), range(48), 0.1)
    b = att.philox_keep(99, 3, range(4), range(32), range(48), 0.1)
    assert torch.equal(a, b)
    # a block of the grid is the same bits as the grid's slice
    part = att.philox_keep(99, 3, range(1, 3), range(8, 24), range(16, 40), 0.1)
    assert torch.equal(part, a[1:3, 8:24, 16:40])


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_another_offset_gives_independent_bits(rate):
    n = 64 * 128 * 128
    a = att.philox_keep(7, 0, range(64), range(128), range(128), rate)
    b = att.philox_keep(7, 1, range(64), range(128), range(128), rate)
    c = att.philox_keep(8, 0, range(64), range(128), range(128), rate)
    keep = 1 - rate
    want = keep ** 2 + (1 - keep) ** 2
    sigma = (want * (1 - want) / n) ** 0.5
    for other in (b, c):
        agree = float((a == other).double().mean())
        assert abs(agree - want) < 4 * sigma, (agree, want)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_kept_fraction_over_a_million_draws(rate):
    bits = att.philox_keep(2024, 11, range(16), range(250), range(250), rate)
    n = bits.numel()
    assert n == 10 ** 6
    frac = float(bits.double().mean())
    assert abs(frac - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** 0.5, frac


def test_draw_seed_is_reproducible_and_fits_the_counter():
    a = [att.draw_seed(torch.Generator().manual_seed(5)) for _ in range(2)]
    assert a[0] == a[1]
    seed, offset = a[0]
    assert 0 <= seed < 2 ** 64 and 0 <= offset <= M32
    gen = torch.Generator().manual_seed(5)
    assert att.draw_seed(gen) != att.draw_seed(gen)


# ---------------------------------------------------------------------------
# statistics and autograd


def test_mean_output_over_seeds_is_attention_without_dropout():
    """E[O] = softmax(s)·V: the kept probabilities are scaled by 1/keep_prob.
    2000 seeds; each element's mean lies within 5 standard errors (its
    sample std over √2000) of the dropout-free output."""
    q, k, v, _, mask = make_inputs(11, 1, 8, 8, 2, 32, "causal")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    m8 = torch.from_numpy(mask).to(torch.int8)
    clean = att.flash_attention(tq, tk, tv, m8).double()
    gen = torch.Generator().manual_seed(0)
    runs = torch.stack([att.flash_attention(tq, tk, tv, m8, dropout_rate=0.3,
                                             philox=att.draw_seed(gen))
                        for _ in range(2000)]).double()
    mean, se = runs.mean(0), runs.std(0) / 2000 ** 0.5
    assert float(se.max()) > 1e-3          # the draws differ from seed to seed
    assert bool(((mean - clean).abs() <= 5 * se + 1e-7).all())


def test_autograd_replays_the_forward_bits():
    """``flash_attention``'s backward draws the forward's bits again from the
    saved (seed, offset): its gradients equal autograd of the O(S²) oracle
    under the bits ``philox_keep`` gives for that pair."""
    q, k, v, g, mask = make_inputs(12, 2, 24, 40, 2, 32, "padding")
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    m8 = torch.from_numpy(mask).to(torch.int8)
    rate = 0.2
    seed, offset = att.draw_seed(torch.Generator().manual_seed(3))
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = att.flash_attention(*xs, m8, dropout_rate=rate,
                              philox=att.draw_seed(torch.Generator().manual_seed(3)), block_q=16,
                              block_k=16)
    out.backward(tg)

    keep = att.philox_keep(seed, offset, range(4), range(24), range(40), rate).view(2, 2, 24, 40)
    ys = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    s = torch.einsum("bqhd,bkhd->bhqk", ys[0], ys[1])
    p = torch.softmax(torch.where(m8[:, None] != 0, s, -1e30), -1)
    p = torch.where(keep, p / att.keep_prob(rate), 0.0)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, ys[2])
    ref.backward(tg)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5, rtol=1e-5)
    for mine, want in zip(xs, ys):
        np.testing.assert_allclose(mine.grad.numpy(), want.grad.numpy(), atol=1e-4, rtol=1e-4)


def test_dropout_needs_a_cpu_generator_and_a_rate_below_one():
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in make_inputs(13, 1, 8, 8, 1, 32, None))
    with pytest.raises(ValueError, match="generator"):
        att.flash_attention(q, k, v, dropout_rate=0.1)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout rate"):
            att.flash_attention(q, k, v, dropout_rate=rate,
                                philox=att.draw_seed(torch.Generator()))
    with pytest.raises(ValueError, match="offset"):
        att.flash_fwd(q, k, v, dropout_rate=0.1, seed=1, offset=2 ** 32)


def test_cpu_dropout_calls_count_no_kernel_launches():
    att.reset_launch_counts()
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in make_inputs(14, 1, 8, 8, 2, 32, None))
    q.requires_grad_()
    att.flash_attention(q, k, v, dropout_rate=0.1,
                        philox=att.draw_seed(torch.Generator().manual_seed(0))).sum().backward()
    assert att.launches == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    assert att.dropout_launches == att.launches
