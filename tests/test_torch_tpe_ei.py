"""TPE's EI scorer and winner pick (``ei_argmax``) against the JAX package's,
on the CPU.

On CPU tensors ``ei_argmax`` runs its plain version, ``ei_argmax_plain``:
the scores of ``_score_rows`` and ``torch.argmax`` over each slot. It is
held to the reference's ``ei_scores`` (the XLA program that the ``tpe_ei``
kernel replaces) and ``jnp.argmax`` on the same numpy inputs: scores within
1e-5, winners equal, with categorical columns, -inf padding components, a
slot whose best score is tied exactly (the first index wins) and a NaN
score (it wins, in both frameworks). The kernel's launch shape, computed
here from the pads alone, is checked too. The kernel itself needs a CUDA card:
``tests/test_torch_tpe_ei_card.py`` holds it to the plain version there,
and ``chip_smoke.py`` at the main path's shapes.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaopt_tpu.ops import tpe_math as R
from metaopt_tpu_torch.ops import tpe_math as P

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
N_OUT, N_CAND, D, KMAX = 3, 6, 4, 3
N_CHOICES = np.array([1, 3, 1, 2], np.int32)        # columns 1 and 3 categorical
HUGE = np.float32(4e18)  # (x - mu) / sigma past 1.8e19: z * z overflows, so l = g = -inf


def member(rng, ng, nb):
    """One member's fit and candidates as numpy arrays: components with
    -inf padding rows, log-prob tables, candidates in the unit cube (the
    categorical columns at their cells' centres)."""
    comps = []
    for n in (ng, nb):
        mu = rng.random((n, D)).astype(np.float32)
        sig = rng.uniform(0.02, 1.0, (n, D)).astype(np.float32)
        sig[:, 0] = rng.uniform(0.02, 0.1, n)          # HUGE overflows column 0
        logw = np.log(rng.uniform(0.1, 1.0, (n, D))).astype(np.float32)
        pad = n - rng.integers(1, n // 2)
        mu[pad:], sig[pad:], logw[pad:] = 0.5, 1.0, -np.inf
        comps += [mu, sig, logw]
    tables = []
    for _ in range(2):
        t = np.full((D, KMAX), np.log(1e-12), np.float32)
        for j, k in enumerate(N_CHOICES):
            t[j, :k] = np.log(rng.dirichlet(np.ones(k)))
        tables.append(t)
    cand = rng.random((N_OUT * N_CAND, D)).astype(np.float32)
    for j, k in enumerate(N_CHOICES):
        if k > 1:
            cand[:, j] = (rng.integers(0, k, len(cand)) + 0.5) / k
    return [*comps, *tables], cand


def reference(fit, cand):
    """The reference's scores (C,) and winners (n_out,) of one member."""
    k = np.maximum(N_CHOICES, 1)
    cat = np.minimum((cand * k).astype(np.int64), k - 1).astype(np.int32)
    g_mu, g_sig, g_logw, b_mu, b_sig, b_logw, g_cat, b_cat = map(jnp.asarray, fit)
    scores = R.ei_scores(jnp.asarray(cand), g_mu, g_sig, g_logw, b_mu, b_sig, b_logw,
                         jnp.asarray((N_CHOICES <= 1).astype(np.float32)), jnp.asarray(cat),
                         g_cat, b_cat)
    return np.asarray(scores), np.asarray(jnp.argmax(scores.reshape(N_OUT, N_CAND), axis=1))


def bucket(B, seed=0):
    """B members' fits and candidates (numpy), with an exact tie at the top
    of member 0's slot 0 and a NaN score in its slot 1."""
    rng = np.random.default_rng(seed)
    members = [member(rng, 16, 32) for _ in range(B)]
    fit, cand = members[0]
    scores, win = reference(fit, cand)
    best = int(win[0])
    if best < N_CAND - 1:
        cand[N_CAND - 1] = cand[best]
    else:
        cand[0] = cand[best]
    cand[N_CAND + 2, 0] = HUGE
    return members


def as_torch(members):
    fit = P.TPEFit(*(torch.from_numpy(np.stack([m[0][i] for m in members])) for i in range(8)))
    cand = torch.from_numpy(np.stack([m[1] for m in members]))
    B = len(members)
    nch = torch.from_numpy(np.tile(N_CHOICES, (B, 1)))
    return fit, cand, nch, nch <= 1


@pytest.mark.parametrize("B", [1, 3])
def test_plain_version_equals_the_reference(B):
    members = bucket(B)
    scores, winners = P.ei_argmax_plain(*as_torch(members), n_out=N_OUT, n_cand=N_CAND)
    for b, (fit, cand) in enumerate(members):
        want_s, want_w = reference(fit, cand)
        np.testing.assert_allclose(scores[b].numpy(), want_s, **TOL)
        np.testing.assert_array_equal(winners[b].numpy(), want_w)
    s0, w0 = scores[0].numpy(), winners[0].numpy()
    slot0 = s0[:N_CAND]
    assert (slot0 == slot0.max()).sum() == 2 and w0[0] == np.argmax(slot0)   # first of a tie
    assert np.isnan(s0[N_CAND + 2]) and w0[1] == 2 and np.isnan(s0).sum() == 1
    assert np.isfinite(s0[2 * N_CAND:]).all()


def test_bucket_rows_equal_solo_calls_bit_for_bit():
    members = bucket(3, seed=1)
    scores, winners = P.ei_argmax_plain(*as_torch(members), n_out=N_OUT, n_cand=N_CAND)
    for b in range(3):
        s1, w1 = P.ei_argmax_plain(*as_torch(members[b:b + 1]), n_out=N_OUT, n_cand=N_CAND)
        assert torch.equal(s1[0].nan_to_num(7.0), scores[b].nan_to_num(7.0))
        assert torch.equal(w1[0], winners[b])


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = as_torch(bucket(3, seed=2))
    before = dict(P.launches)
    s, w = P.ei_argmax(*args, n_out=N_OUT, n_cand=N_CAND)
    ps, pw = P.ei_argmax_plain(*args, n_out=N_OUT, n_cand=N_CAND)
    assert torch.equal(s.nan_to_num(7.0), ps.nan_to_num(7.0)) and torch.equal(w, pw)
    fit, cand, nch, cont = args
    k = torch.clamp(nch, min=1)
    cat = torch.minimum((cand * k[:, None, :]).long(), (k - 1)[:, None, :])
    es = P.ei_scores(cand, *fit[:6], cont.float(), cat, *fit[6:])
    assert torch.equal(es.nan_to_num(7.0), ps.nan_to_num(7.0))
    assert P.launches == before


NO_CARD = r"""
import numpy as np, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from metaopt_tpu_torch.ops import tpe_math as P
assert not torch.cuda.is_available()
with FakeTensorMode():
    B, C, d, n = 2, 12, 4, 8
    fit = P.TPEFit(*(torch.zeros(B, n, d, device="cuda") for _ in range(6)),
                   *(torch.zeros(B, d, 3, device="cuda") for _ in range(2)))
    cand = torch.zeros(B, C, d, device="cuda")
    nch = torch.ones(B, d, dtype=torch.int32, device="cuda")
    for call in (lambda: P.ei_argmax(fit, cand, nch, nch > 0, n_out=2, n_cand=6),
                 lambda: P.ei_scores(cand, *fit[:6], torch.ones(B, d, device="cuda"),
                                     torch.zeros(B, C, d, dtype=torch.int64, device="cuda"),
                                     *fit[6:])):
        try:
            call()
        except RuntimeError as err:
            print("raised:", err)
        else:
            raise SystemExit("a CUDA tensor ran without the kernel")
assert P.launches == {"tpe_ei": 0}
"""


def test_a_cuda_tensor_without_a_card_raises_rather_than_drifting():
    """Tensors that claim ``cuda`` (fake tensors: this machine has no card)
    reach the kernel's build, which raises; neither wrapper falls back to
    the plain version. A fresh process: fake tensors import
    ``torch._dynamo``, which no other test's process should carry."""
    out = subprocess.run([sys.executable, "-c", NO_CARD], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("raised:") == 2


# the main path's launches: [tpe] n 16 and 4096, [ledger] n ~10k, [coord]
# (d)'s bucket, the n 50,000 check; (ng, nb, n_cand) -> (cluster, warps, k)
LAUNCHES = {
    "n16": ((8, 16, 24), (1, 1, 1)),
    "bucket": ((64, 256, 24), (1, 5, 1)),
    "n4096": ((2048, 4096, 24), (8, 12, 1)),
    "n10k": ((4096, 8192, 24), (8, 16, 1)),
    "n50000": ((16384, 40960, 24), (8, 16, 1)),
    "cand40": ((2048, 4096, 40), (8, 12, 2)),
    "cand1": ((128, 512, 1), (2, 5, 1)),
    "unpadded": ((17, 4100, 24), (8, 9, 1)),
}


@pytest.mark.parametrize("case", list(LAUNCHES))
def test_the_launch_shape_follows_the_pads(case):
    """The kernel's launch shape is a function of the pads and the slot's
    candidates alone (``ei_launch_shape`` takes no member count): the order
    of the kernel's additions follows it, so a bucket row stays the bits of
    the member's solo row. A solo launch at n ~10k runs 8 slots x 8 CTAs,
    against the 8 blocks of one per slot."""
    (ng, nb, n_cand), want = LAUNCHES[case]
    shape = P.ei_launch_shape(ng, nb, n_cand)
    assert (shape.cluster, shape.warps, shape.k) == want
    assert list(inspect.signature(P.ei_launch_shape).parameters) == ["ng", "nb", "n_cand"]
    assert 32 * shape.k >= min(n_cand, 64)
