"""TPE surrogate math on torch tensors (port of ``metaopt_tpu/ops/tpe_math.py``).

Observations split at the γ-quantile into good/bad sets; per-dimension
adaptive-bandwidth Parzen estimators l(x) and g(x); candidates drawn from l
and ranked by EI ∝ l(x)/g(x). The reference compiles this into one XLA
program; here it is eager PyTorch on an explicit device (the tensors'),
with observation counts padded to the same powers of two so launch shapes
match the reference's.

- ``pad_pow2``, ``adaptive_bandwidths`` and ``split_pads`` are host numpy,
  copied unchanged: they are exact.
- The device functions keep the reference's arithmetic in float32. Every
  scalar that the reference traced (live counts, γ, the prior weight) is a
  host number here, so a launch never waits on the device until its one
  readback. Sorts are stable (``jnp.argsort`` is), which orders ties of the
  ``_BIG`` fill and sends a NaN objective past the ``+inf`` padding as the
  reference does.
- Category counts are a one-hot product summed over observations, not a
  scatter-add: CUDA's ``index_add_`` uses atomics, whose order, and so
  whose float32 sum, changes from run to run.
- Random draws come in as tensors (``draws``) to ``_tpe_suggest_body``.
  ``tpe_suggest_fused`` makes them from one ``torch.Generator`` per pool,
  seeded by an integer hash of (kernel seed, observation count, pool
  index): the stream is a pure function of those three, as the reference's
  ``fold_in(fold_in(key, n_obs), pool)`` keying is. The generator is the
  device's: Philox on ``cuda``, mt19937 on the CPU, so the two devices draw
  different streams; threefry cannot be matched on either.

Not ported yet: ``tpe_suggest_fleet`` (the coordinator's bucket launch).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))
_BIG = 1e9


def pad_pow2(n: int, minimum: int = 8) -> int:
    """Padded buffer size ≥ max(n, minimum): powers of two up to 4096,
    then 4096-step multiples (bounds the padding waste by 4096/n past
    that point while keeping launch shapes to O(n/4096) variants)."""
    p = minimum
    while p < n and p < 4096:
        p *= 2
    if p >= n:
        return p
    return ((n + 4095) // 4096) * 4096


def adaptive_bandwidths(sorted_mu: np.ndarray) -> np.ndarray:
    """Per-component sigmas for a 1-D Parzen mixture on [0, 1].

    Each point's sigma is the larger of the gaps to its sorted neighbours
    (edge points use the gap to the domain bound), clipped to
    [1/min(100, n+1), 1]. Host-side numpy.
    """
    n = len(sorted_mu)
    if n == 0:
        return np.zeros(0)
    if n == 1:
        return np.ones(1)
    ext = np.concatenate([[0.0], sorted_mu, [1.0]])
    left = sorted_mu - ext[:-2]
    right = ext[2:] - sorted_mu
    sig = np.maximum(left, right)
    sig_min = 1.0 / min(100.0, n + 1.0)
    return np.clip(sig, sig_min, 1.0)


def _n_below(n: int, gamma: float) -> int:
    """Good-set size of the γ-split, in float32 as the reference's traced
    ``ceil(gamma * n)``: a float64 ceil disagrees at a rounding edge."""
    n = int(n)
    n_below = int(np.ceil(np.float32(gamma) * np.float32(n)))
    return min(max(1, n_below), max(n, 1))


def split_pads(n: int, gamma: float) -> tuple:
    """Static (n_good_pad, n_bad_pad) for a live count: room for the γ-split
    subset plus its prior pseudo-component row."""
    n = int(n)
    n_below = _n_below(n, gamma)
    return pad_pow2(n_below + 1), pad_pow2(max(n - n_below, 0) + 1)


def _mixture_logpdf(x, mu, sigma, logw):
    """log pdf of per-dimension mixtures of [0,1]-truncated Gaussians.

    x (C, d) evaluation points; mu, sigma, logw (N, d) components (sigma
    > 0 even for padding, logw -inf for padding). Returns (C, d). The
    (C, N, d) intermediates are materialized: 12.6 MB each at C 192,
    N 4096, d 4.
    """
    z = (x[:, None, :] - mu[None]) / sigma[None]
    log_phi = -0.5 * z * z - _HALF_LOG_2PI - torch.log(sigma)[None]
    # truncation mass on [0,1] per component
    a = torch.special.ndtr((1.0 - mu) / sigma)
    b = torch.special.ndtr((0.0 - mu) / sigma)
    log_mass = torch.log(torch.clamp(a - b, 1e-12, 1.0))
    return torch.logsumexp(log_phi - log_mass[None] + logw[None], dim=1)


def ei_scores(cand, good_mu, good_sigma, good_logw, bad_mu, bad_sigma, bad_logw,
              cont_mask, cand_cat_idx, good_cat_logp, bad_cat_logp):
    """EI ranking for TPE: log l(x) − log g(x), shape (C,).

    Continuous columns use the truncated-Gaussian Parzen mixtures;
    categorical columns (``cont_mask`` 0) look up the per-dim category
    log-probs (d, K) at ``cand_cat_idx`` (C, d).
    """
    log_l_cont = _mixture_logpdf(cand, good_mu, good_sigma, good_logw)
    log_g_cont = _mixture_logpdf(cand, bad_mu, bad_sigma, bad_logw)
    d_idx = torch.arange(cand.shape[1], device=cand.device)[None, :]
    log_l_cat = good_cat_logp[d_idx, cand_cat_idx]
    log_g_cat = bad_cat_logp[d_idx, cand_cat_idx]
    cont = cont_mask[None, :] > 0
    log_l = torch.where(cont, log_l_cont, log_l_cat)
    log_g = torch.where(cont, log_g_cont, log_g_cat)
    return torch.sum(log_l - log_g, dim=1)


def _recency_weights(n: int, idx, full_weight_num, equal_weight: bool):
    """Observation-order weights (lineage forgetting ramp), float32.

    The newest ``full_weight_num`` points get weight 1.0; older points
    ramp linearly from 1/n up (numpy ``linspace(1/n, 1, n - fwn)``
    semantics, including the single-element case). ``idx`` is the row
    index tensor; the scalars are host numbers.
    """
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    if equal_weight or n <= full_weight_num:
        return ones
    m = n - full_weight_num                       # number of ramped (old) points
    lo = np.float32(1.0) / np.float32(max(n, 1))
    if m == 1:                                    # linspace(1/n, 1, 1) == [1/n]
        ramp = torch.full_like(ones, float(lo))
    else:
        step = (np.float32(1.0) - lo)
        ramp = idx.to(torch.float32) * float(step) / float(np.float32(m - 1)) + float(lo)
    return torch.where(idx >= m, ones, ramp)


def _fit_set_device(X, w_sel, count: int, prior_weight: float):
    """Per-dim sorted Parzen components for one (masked) observation subset.

    X (N, d) unit-cube rows; w_sel (N,) recency weights, 0.0 outside the
    subset; ``count`` the subset size. Returns mu, sigma, logw of shape
    (N, d) with the prior pseudo-component at row ``count`` and -inf
    log-weight padding elsewhere.
    """
    npad, d = X.shape
    dev = X.device
    row = torch.arange(npad, device=dev)[:, None]
    in_set = w_sel > 0.0

    xg = torch.where(in_set[:, None], X, _BIG)
    sort_idx = torch.argsort(xg, dim=0, stable=True)
    xs = torch.gather(xg, 0, sort_idx)
    ws = torch.gather(w_sel[:, None].expand(npad, d), 0, sort_idx)

    valid = row < count
    prev = torch.cat([torch.zeros(1, d, device=dev), xs[:-1]], dim=0)
    nxt = torch.cat([xs[1:], torch.full((1, d), _BIG, device=dev)], dim=0)
    left = xs - prev
    right = torch.where(row == count - 1, 1.0 - xs, nxt - xs)
    sig = torch.maximum(left, right)
    sig_min = np.float32(1.0) / min(np.float32(100.0), np.float32(count) + np.float32(1.0))
    sig = torch.clamp(sig, float(sig_min), 1.0)
    if count == 1:                                # host rule: single point → 1.0
        sig = torch.ones_like(sig)

    log_pw = float(np.log(np.float32(max(prior_weight, 1e-12))))
    mu = torch.where(valid, xs, 0.5)
    sigma = torch.where(valid, sig, 1.0)
    logw = torch.where(valid, torch.log(torch.clamp(ws, min=1e-12)), -torch.inf)
    logw = torch.where(row == count, log_pw, logw)
    return mu, sigma, logw


def _categorical_cdf(u, logits):
    """Categorical draws by inverse CDF: ``u`` (C, d) uniforms, ``logits``
    (d, K). Returns (C, d) int64 category indices.

    Selection is "first k with cdf[k] >= u", i.e. the count of CDF steps
    below u: the reference's ``sum(u[..., None] > cdf)``, found by a
    binary search (the CDF, a cumulative sum of non-negative terms, never
    decreases in floating point either). A zero-probability category has
    cdf[k] == cdf[k-1] and is never drawn; the clamp guards u ~ 1.0.
    """
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    draw = torch.searchsorted(cdf, u.T.contiguous()).T
    return torch.clamp(draw, max=logits.shape[-1] - 1)


def _cat_tables_device(X, w_sel, n_choices, prior_weight: float, kmax: int):
    """Re-weighted category frequency tables, (d, kmax) log-probs.

    The counts are a one-hot (N, d, kmax) product with the weights, summed
    over N in a fixed order (deterministic on CUDA, unlike a scatter-add).
    """
    k = torch.clamp(n_choices, min=1)                             # (d,)
    cat_idx = torch.minimum((X * k[None, :]).to(torch.int64), (k - 1)[None, :])
    col = torch.arange(kmax, device=X.device)
    base = torch.where(col[None, :] < k[:, None], prior_weight, 0.0)  # (d, K)
    onehot = cat_idx[:, :, None] == col[None, None, :]            # (N, d, K)
    counts = base + torch.sum(onehot * w_sel[:, None, None], dim=0)
    probs = counts / torch.clamp(counts.sum(dim=1, keepdim=True), min=1e-12)
    return torch.log(torch.clamp(probs, min=1e-12))


class TPEFit(NamedTuple):
    """The l/g fit of one launch: Parzen components (Ng or Nb, d) and
    category log-prob tables (d, kmax)."""

    g_mu: torch.Tensor
    g_sig: torch.Tensor
    g_logw: torch.Tensor
    b_mu: torch.Tensor
    b_sig: torch.Tensor
    b_logw: torch.Tensor
    g_cat: torch.Tensor
    b_cat: torch.Tensor


def _tpe_fit(X, y, n: int, n_choices, gamma: float, prior_weight: float,
             full_weight_num, n_prior: int = 0, transfer_discount: float = 1.0, *,
             kmax: int, equal_weight: bool, n_good_pad: int = 0,
             n_bad_pad: int = 0) -> TPEFit:
    """γ-split by objective rank, then the compacted good/bad fits.

    X (N, d), y (N,) padded buffers (``+inf`` objectives past ``n``);
    the good set is fit over ``n_good_pad`` rows and the bad set over
    ``n_bad_pad`` (``split_pads``), 0 meaning the full buffer width.
    """
    npad, _ = X.shape
    dev = X.device
    n_good_pad = n_good_pad or npad
    n_bad_pad = n_bad_pad or npad
    idx = torch.arange(npad, device=dev)

    # γ-split by objective rank (padding sorts last via +inf, NaN after it)
    order = torch.argsort(torch.where(idx < n, y, torch.inf), stable=True)
    # safety clamp: never index past the prior row of the good pad
    n_below = min(_n_below(n, gamma), n_good_pad - 1)
    w_obs = _recency_weights(n, idx, full_weight_num, equal_weight)
    if n_prior and transfer_discount != 1.0:
        # transfer priors (EVC warm-start) occupy the oldest rows
        w_obs = w_obs * torch.where(idx < n_prior, float(np.float32(transfer_discount)), 1.0)
    ng = min(n_below, n)
    nb = max(n - n_below, 0)

    # compact gather: good rows are order[0:n_below], bad rows follow
    gpos = torch.arange(n_good_pad, device=dev)
    gsel = order[torch.clamp(gpos, max=npad - 1)]
    w_good = torch.where(gpos < ng, w_obs[gsel], 0.0)
    Xg = X[gsel]
    bpos = n_below + torch.arange(n_bad_pad, device=dev)
    bsel = order[torch.clamp(bpos, max=npad - 1)]
    w_bad = torch.where(bpos < n, w_obs[bsel], 0.0)
    Xb = X[bsel]

    g = _fit_set_device(Xg, w_good, ng, prior_weight)
    b = _fit_set_device(Xb, w_bad, nb, prior_weight)
    g_cat = _cat_tables_device(Xg, w_good, n_choices, prior_weight, kmax)
    b_cat = _cat_tables_device(Xb, w_bad, n_choices, prior_weight, kmax)
    return TPEFit(*g, *b, g_cat, b_cat)


def _sample_candidates(fit: TPEFit, draws, n_choices, cont_mask, kmax: int):
    """Candidates (C, d) drawn from l: a mixture component per slot and a
    Gaussian draw around it (one redraw when it leaves [0, 1], then a
    clip), and a category per categorical slot from l's table.

    ``draws`` = (u_comp, z_draw, z_redraw, u_cat), each (C, d): uniforms
    in [0, 1) and standard normals.
    """
    u_comp, z_draw, z_redraw, u_cat = draws
    k = torch.clamp(n_choices, min=1)
    comp = _categorical_cdf(u_comp, fit.g_logw.T)
    mu_c = torch.gather(fit.g_mu, 0, comp)
    sig_c = torch.gather(fit.g_sig, 0, comp)
    x = mu_c + sig_c * z_draw
    redraw = mu_c + sig_c * z_redraw
    oob = (x < 0.0) | (x > 1.0)
    x = torch.clamp(torch.where(oob, redraw, x), 1e-6, 1.0 - 1e-6)

    cat_logits = torch.where(torch.arange(kmax, device=k.device)[None, :] < k[:, None],
                             fit.g_cat, -torch.inf)
    cats = _categorical_cdf(u_cat, cat_logits)
    cat_vals = (cats.to(torch.float32) + 0.5) / k[None, :]
    return torch.where(cont_mask[None, :], x, cat_vals)


def _score_candidates(fit: TPEFit, cand, n_choices, cont_mask):
    """EI score log l(x) − log g(x) of each candidate row, shape (C,)."""
    k = torch.clamp(n_choices, min=1)
    cand_cat = torch.minimum((cand * k[None, :]).to(torch.int64), (k - 1)[None, :])
    return ei_scores(cand, fit.g_mu, fit.g_sig, fit.g_logw, fit.b_mu, fit.b_sig,
                     fit.b_logw, cont_mask.to(torch.float32), cand_cat,
                     fit.g_cat, fit.b_cat)


def _tpe_suggest_body(
    X, y, n: int, draws: Sequence[Tuple[torch.Tensor, ...]], n_choices, cont_mask,
    gamma: float, prior_weight: float, full_weight_num, n_prior: int = 0,
    transfer_discount: float = 1.0, *, n_cand: int, n_out: int, kmax: int,
    equal_weight: bool, n_good_pad: int = 0, n_bad_pad: int = 0,
):
    """Fit once, then for each pool's draws score ``n_cand`` candidates per
    output slot and keep the best. Returns (len(draws) * n_out, d)."""
    fit = _tpe_fit(X, y, n, n_choices, gamma, prior_weight, full_weight_num,
                   n_prior, transfer_discount, kmax=kmax, equal_weight=equal_weight,
                   n_good_pad=n_good_pad, n_bad_pad=n_bad_pad)
    d = X.shape[1]
    slots = torch.arange(n_out, device=X.device)
    outs = []
    for pool in draws:
        cand = _sample_candidates(fit, pool, n_choices, cont_mask, kmax)
        scores = _score_candidates(fit, cand, n_choices, cont_mask)
        winners = torch.argmax(scores.reshape(n_out, n_cand), dim=1)
        outs.append(cand.reshape(n_out, n_cand, d)[slots, winners])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(kernel_seed: int, n_obs: int) -> int:
    """Seed of the draws at one fit (the reference's ``fold_in(base,
    n_obs)``); pools at that fit fold their index in (``pool_draws``)."""
    return _splitmix64(_splitmix64(int(kernel_seed) & _M64) ^ int(n_obs))


def pool_draws(fit_seed: int, pool: int, C: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    """(u_comp, z_draw, z_redraw, u_cat), each (C, d), from a generator of
    ``device`` seeded by (fit seed, pool index) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_splitmix64(fit_seed ^ _splitmix64(int(pool))) >> 1)
    shape = (C, d)
    return (torch.rand(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device),
            torch.rand(shape, generator=gen, device=device))


def tpe_suggest_fused(
    X, y, n: int, count: int, fit_seed: int, n_choices, cont_mask, gamma: float,
    prior_weight: float, full_weight_num, n_prior: int = 0,
    transfer_discount: float = 1.0, *, n_cand: int, n_out: int, kmax: int,
    equal_weight: bool, n_good_pad: int = 0, n_bad_pad: int = 0, n_pools: int = 1,
    draws: Optional[List[Tuple[torch.Tensor, ...]]] = None,
):
    """Whole suggest pools in one call, on the buffers' device.

    Pool ``p`` draws from ``pool_draws(fit_seed, count + p, ...)``: exactly
    the stream a separate call at stream position ``count + p`` would use,
    so one call with ``n_pools`` pools equals ``n_pools`` single calls bit
    for bit. ``draws``, when given, replaces the generated draws (one
    4-tuple per pool). Returns (n_pools * n_out, d) winners on the device.
    """
    if draws is None:
        C, d = n_out * n_cand, X.shape[1]
        draws = [pool_draws(fit_seed, count + p, C, d, X.device) for p in range(n_pools)]
    return _tpe_suggest_body(
        X, y, n, draws, n_choices, cont_mask, gamma, prior_weight, full_weight_num,
        n_prior, transfer_discount, n_cand=n_cand, n_out=n_out, kmax=kmax,
        equal_weight=equal_weight, n_good_pad=n_good_pad, n_bad_pad=n_bad_pad)
