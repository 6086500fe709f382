"""The ``tpe_ei`` kernel against its plain version on a CUDA card.

These tests skip where torch sees no card. This file imports no JAX, so it
runs on the card's machine without the reference:
``python -m pytest --noconftest -m cuda tests/test_torch_tpe_ei_card.py``.
``chip_smoke.py`` makes the same comparison at the main path's shapes.

Scores within 1e-5 (rtol and atol) of the plain version on the same fit
and candidates; winners equal except in a slot whose two best plain scores
lie within that bound of each other; every row of a bucket launch equal to
the member's own launch bit for bit (no block reads another member).
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


def inputs(B, n, n_out, n_cand, seed, dev):
    """B members' fits (d 4, the last column categorical with 3 choices)
    and candidates drawn from them, on ``dev``."""
    rng = np.random.default_rng(seed)
    npad, d = P.pad_pow2(n), 4
    X = rng.random((B, npad, d)).astype(np.float32)
    X[:, :, 3] = (rng.integers(0, 3, (B, npad)) + 0.5) / 3
    y = rng.normal(size=(B, npad)).astype(np.float32)
    y[:, n:] = np.inf
    gp, bp = P.split_pads(n, 0.25)
    rows = [P._member_scalars(n, 0.25, 1.0, 25, 0, 1.0, False, gp) for _ in range(B)]
    ints = torch.tensor([r[0] for r in rows], device=dev)
    floats = torch.tensor(np.array([r[1] for r in rows], np.float32), device=dev)
    nch = torch.tensor([[1, 1, 1, 3]] * B, dtype=torch.int32, device=dev)
    fit = P._tpe_fit_rows(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), ints,
                          floats, nch, kmax=3, n_good_pad=gp, n_bad_pad=bp)
    C = n_out * n_cand
    draws = [torch.from_numpy(rng.random((B, C, d)).astype(np.float32) if i in (0, 3)
                              else rng.standard_normal((B, C, d)).astype(np.float32)).to(dev)
             for i in range(4)]
    return fit, P._sample_rows(fit, draws, nch, nch <= 1, 3), nch, nch <= 1


def tie_slots(scores, n_out, n_cand):
    """(B, n_out): slots whose two best scores lie within the bound."""
    top = scores.reshape(scores.shape[0], n_out, n_cand).topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]).abs() <= TOL + TOL * top[..., 1].abs()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,n_out,n_cand", [(1, 16, 8, 24), (3, 300, 4, 24), (2, 5000, 2, 40)])
def test_the_kernel_equals_its_plain_version(card, B, n, n_out, n_cand):
    fit, cand, nch, cont = inputs(B, n, n_out, n_cand, seed=n, dev=card)
    before = P.launches["tpe_ei"]
    ks, kw = P.ei_argmax(fit, cand, nch, cont, n_out=n_out, n_cand=n_cand)
    ps, pw = P.ei_argmax_plain(fit, cand, nch, cont, n_out=n_out, n_cand=n_cand)
    torch.cuda.synchronize()
    assert P.launches["tpe_ei"] == before + 1
    torch.testing.assert_close(ks, ps, rtol=TOL, atol=TOL)
    assert not ((kw != pw) & ~tie_slots(ps, n_out, n_cand)).any()
    for b in range(B):
        one = P.TPEFit(*(t[b:b + 1] for t in fit))
        s1, w1 = P.ei_argmax(one, cand[b:b + 1], nch[b:b + 1], cont[b:b + 1], n_out=n_out,
                             n_cand=n_cand)
        assert torch.equal(s1[0], ks[b]) and torch.equal(w1[0], kw[b])
    k = torch.clamp(nch, min=1)
    cat = torch.minimum((cand * k[:, None, :]).long(), (k - 1)[:, None, :])
    es = P.ei_scores(cand, *fit[:6], cont.float(), cat, *fit[6:])
    assert torch.equal(es, ks)
