"""The ``tpe_ei`` kernel against its plain version on a CUDA card.

These tests skip where torch sees no card. This file imports no JAX, so it
runs on the card's machine without the reference:
``python -m pytest --noconftest -m cuda tests/test_torch_tpe_ei_card.py``.
``chip_smoke.py`` makes the same comparison at the main path's shapes.

Scores within 1e-5 (rtol and atol) of the plain version on the same fit
and candidates, with the same NaN and infinities; winners equal except in
a slot whose two best plain scores lie within that bound of each other;
every row of a bucket launch equal to the member's own launch bit for bit
(no CTA reads another member, and the kernel's order of additions follows
the pads alone); ``ei_scores`` the same bits as ``ei_argmax``'s scores.
The cases reach the kernel's edges: clusters of 1 to 16 CTAs, ranges of
padding alone or of nothing, one to two rounds of candidates, d 1 to 4.
"""

import numpy as np
import pytest
import torch

from metaopt_tpu_torch.ops import tpe_math as P

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tpe_ei kernel has no CPU mode "
                    "(chip_smoke.py checks it on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(B, n, n_out, n_cand, seed, dev, d=4, pads=None):
    """B members' fits and candidates drawn from them, on ``dev``: d
    columns, the last categorical with 3 choices when d >= 3; the fits
    over the γ-split's pads, or over ``pads`` (good, bad) when given."""
    rng = np.random.default_rng(seed)
    npad = P.pad_pow2(n)
    X = rng.random((B, npad, d)).astype(np.float32)
    choices = [1] * d
    if d >= 3:
        X[:, :, d - 1] = (rng.integers(0, 3, (B, npad)) + 0.5) / 3
        choices[d - 1] = 3
    y = rng.normal(size=(B, npad)).astype(np.float32)
    y[:, n:] = np.inf
    gp, bp = pads or P.split_pads(n, 0.25)
    rows = [P._member_scalars(n, 0.25, 1.0, 25, 0, 1.0, False, gp) for _ in range(B)]
    ints = torch.tensor([r[0] for r in rows], device=dev)
    floats = torch.tensor(np.array([r[1] for r in rows], np.float32), device=dev)
    nch = torch.tensor([choices] * B, dtype=torch.int32, device=dev)
    fit = P._tpe_fit_rows(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), ints,
                          floats, nch, kmax=3, n_good_pad=gp, n_bad_pad=bp)
    C = n_out * n_cand
    draws = [torch.from_numpy(rng.random((B, C, d)).astype(np.float32) if i in (0, 3)
                              else rng.standard_normal((B, C, d)).astype(np.float32)).to(dev)
             for i in range(4)]
    return fit, P._sample_rows(fit, draws, nch, nch <= 1, 3), nch, nch <= 1


def poison(fit):
    """Member 0: a component with a NaN weight (its scores are NaN);
    member 1: column 1's bad mixture all -inf weights (+inf scores);
    member 2: column 0's good mixture all -inf (-inf scores)."""
    g_logw, b_logw = fit.g_logw.clone(), fit.b_logw.clone()
    g_logw[0, 5, 0] = float("nan")
    b_logw[1, :, 1] = -float("inf")
    g_logw[2, :, 0] = -float("inf")
    return fit._replace(g_logw=g_logw, b_logw=b_logw)


def tie_slots(scores, n_out, n_cand):
    """(B, n_out): slots whose two best scores lie within the bound."""
    if n_cand < 2:
        return torch.zeros(scores.shape[0], n_out, dtype=torch.bool, device=scores.device)
    top = scores.reshape(scores.shape[0], n_out, n_cand).topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]).abs() <= TOL + TOL * top[..., 1].abs()


# (B, n, n_out, n_cand, d, pads, poisoned): the main path's n 16 and a
# bucket of 32; d 1 and 3; pads that are not multiples of a CTA's range
# (1001 and 3003 over clusters of 8); pads that leave CTAs only padding or
# nothing (17 good rows over a cluster of 8); one candidate a slot, and 40
# and 70 (above 32: two candidates a lane, and two rounds of 64); NaN and
# -inf weights; the 50,000-trial scale (pads 16384 and 40960)
CASES = {
    "n16": (1, 16, 8, 24, 4, None, False),
    "n300-B3": (3, 300, 4, 24, 4, None, False),
    "n5000-cand40": (2, 5000, 2, 40, 4, None, False),
    "d3": (2, 4096, 2, 24, 3, None, False),
    "d1": (2, 4096, 2, 24, 1, None, False),
    "ragged-ranges": (2, 3000, 2, 24, 4, (1001, 3003), False),
    "padding-ranges": (2, 40, 2, 24, 4, (17, 4100), False),
    "cand1": (2, 300, 8, 1, 4, None, False),
    "cand70": (1, 300, 2, 70, 4, None, False),
    "bucket32": (32, 220, 8, 24, 4, None, False),
    "nan-inf-weights": (3, 300, 4, 24, 4, None, True),
    "n50000": (1, 50_000, 8, 24, 4, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_the_kernel_equals_its_plain_version(card, case):
    B, n, n_out, n_cand, d, pads, poisoned = CASES[case]
    fit, cand, nch, cont = inputs(B, n, n_out, n_cand, seed=n, dev=card, d=d, pads=pads)
    if poisoned:
        fit = poison(fit)
    before = P.launches["tpe_ei"]
    ks, kw = P.ei_argmax(fit, cand, nch, cont, n_out=n_out, n_cand=n_cand)
    ps, pw = P.ei_argmax_plain(fit, cand, nch, cont, n_out=n_out, n_cand=n_cand)
    torch.cuda.synchronize()
    assert P.launches["tpe_ei"] == before + 1
    torch.testing.assert_close(ks, ps, rtol=TOL, atol=TOL, equal_nan=True)
    if poisoned:
        assert ks[0].isnan().all() and ks[1].isposinf().all() and ks[2].isneginf().all()
    assert not ((kw != pw) & ~tie_slots(ps, n_out, n_cand)).any()
    for b in range(B):
        one = P.TPEFit(*(t[b:b + 1] for t in fit))
        s1, w1 = P.ei_argmax(one, cand[b:b + 1], nch[b:b + 1], cont[b:b + 1], n_out=n_out,
                             n_cand=n_cand)
        assert torch.equal(s1[0].nan_to_num(7.0), ks[b].nan_to_num(7.0))
        assert torch.equal(w1[0], kw[b])
    k = torch.clamp(nch, min=1)
    cat = torch.minimum((cand * k[:, None, :]).long(), (k - 1)[:, None, :])
    es = P.ei_scores(cand, *fit[:6], cont.float(), cat, *fit[6:])
    assert torch.equal(es.nan_to_num(7.0), ks.nan_to_num(7.0))


@pytest.mark.cuda
def test_a_refused_cluster_launch_raises(card):
    """A launch shape that the entry point refuses (a cluster of 32 CTAs,
    beyond the 16 it takes) raises; nothing falls back."""
    fit, cand, nch, cont = inputs(1, 300, 2, 6, seed=1, dev=card)
    real = P.ei_launch_shape
    P.ei_launch_shape = lambda ng, nb, n_cand: real(ng, nb, n_cand)._replace(cluster=32)
    try:
        before = P.launches["tpe_ei"]
        with pytest.raises(RuntimeError, match="tpe_ei"):
            P.ei_argmax(fit, cand, nch, cont, n_out=2, n_cand=6)
        assert P.launches["tpe_ei"] == before
    finally:
        P.ei_launch_shape = real
