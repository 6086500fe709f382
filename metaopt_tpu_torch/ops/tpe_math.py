"""TPE surrogate math on torch tensors (port of ``metaopt_tpu/ops/tpe_math.py``).

Observations split at the γ-quantile into good/bad sets; per-dimension
adaptive-bandwidth Parzen estimators l(x) and g(x); candidates drawn from l
and ranked by EI ∝ l(x)/g(x). The reference compiles this into one XLA
program; here it is eager PyTorch on an explicit device (the tensors'),
with observation counts padded to the same powers of two so launch shapes
match the reference's.

- ``pad_pow2``, ``adaptive_bandwidths`` and ``split_pads`` are host numpy,
  copied unchanged: they are exact.
- The device functions keep the reference's arithmetic in float32.
- One body serves a single experiment and a bucket of experiments: every
  device function takes a leading member axis B, and the solo launch
  (:func:`tpe_suggest_fused`) is the B = 1 case of the fleet launch
  (:func:`tpe_suggest_fleet`), as the reference vmaps one traced body for
  both. Every scalar that the reference traced per member (live count, the
  γ-split size, the recency ramp, the bandwidth floors, the prior weight)
  is computed on the host in numpy float32 (:func:`_member_scalars`) and
  reaches the device as one row of two (B, k) tensors, copied without a
  device sync; a launch never waits on the device until its one readback.
  Each scalar is thus computed the same way in both paths, and a row of a
  bucket launch equals the member's solo launch bit for bit on the CPU.
- Sorts are stable (``jnp.argsort`` is), which orders ties of the
  ``_BIG`` fill and sends a NaN objective past the ``+inf`` padding as the
  reference does.
- Category counts are a one-hot product summed over observations, not a
  scatter-add: CUDA's ``index_add_`` uses atomics, whose order, and so
  whose float32 sum, changes from run to run.
- The EI scorer and each slot's argmax run as one hand-written kernel on
  the card (``csrc/tpe_ei.cu``, through :func:`ei_argmax` and
  :func:`ei_scores`), counted in :data:`launches`; on CPU tensors the same
  wrappers run the plain PyTorch version (:func:`ei_argmax_plain`), which
  is also what the kernel is checked against on the card. There is no
  fallback from a CUDA tensor to the plain path.
- Random draws come in as tensors (``draws``) to ``_tpe_suggest_body``.
  ``tpe_suggest_fused`` makes them from one ``torch.Generator`` per pool,
  seeded by an integer hash of (kernel seed, observation count, pool
  index): the stream is a pure function of those three, as the reference's
  ``fold_in(fold_in(key, n_obs), pool)`` keying is. The generator is the
  device's: Philox on ``cuda``, mt19937 on the CPU, so the two devices draw
  different streams; threefry cannot be matched on either. A bucket launch
draws each member's pools from that member's own generators, so a fused
row draws exactly what the member's own refill would; those four RNG
kernels per member and pool are the only part of a bucket launch whose
count grows with B.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))
_BIG = 1e9

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
launches: Dict[str, int] = {"tpe_ei": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


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


def _sig_min(count: int) -> np.float32:
    """Bandwidth floor 1 / min(100, count + 1), in float32."""
    return np.float32(1.0) / min(np.float32(100.0), np.float32(count) + np.float32(1.0))


#: columns of the per-member scalar tensors (see :func:`_member_scalars`)
_I_N, _I_NBELOW, _I_NG, _I_NB, _I_RAMP, _I_NPRIOR = range(6)
_F_LO, _F_STEP, _F_DENOM, _F_TD, _F_SIGG, _F_SIGB, _F_LOGPW, _F_PW = range(8)


def _ramp_scalars(n: int, full_weight_num, equal_weight: bool) -> Tuple[int, tuple]:
    """(m, (lo, step, denom)) of the recency ramp: rows ``idx >= m`` weigh
    1.0, older rows ``idx * step / denom + lo`` (numpy ``linspace(1/n, 1,
    n - fwn)`` semantics, including the single-element case). ``m = 0``
    when every row weighs 1.0."""
    one = np.float32(1.0)
    if equal_weight or n <= full_weight_num:
        return 0, (one, np.float32(0.0), one)
    m = int(n - full_weight_num)                  # number of ramped (old) points
    lo = one / np.float32(max(n, 1))
    if m == 1:                                    # linspace(1/n, 1, 1) == [1/n]
        return m, (lo, np.float32(0.0), one)
    return m, (lo, one - lo, np.float32(m - 1))


def _member_scalars(n: int, gamma: float, prior_weight: float, full_weight_num,
                    n_prior: int, transfer_discount: float, equal_weight: bool,
                    n_good_pad: int) -> Tuple[tuple, tuple]:
    """One member's host scalars: (ints, floats) in the ``_I_*`` / ``_F_*``
    column order, each computed in numpy float32 as the reference's traced
    arithmetic does."""
    n = int(n)
    # safety clamp: never index past the prior row of the good pad
    n_below = min(_n_below(n, gamma), n_good_pad - 1)
    ng, nb = min(n_below, n), max(n - n_below, 0)
    m, (lo, step, denom) = _ramp_scalars(n, full_weight_num, equal_weight)
    # transfer priors (EVC warm-start) occupy the oldest rows; a factor of
    # exactly 1.0 elsewhere leaves the weights as they are
    if n_prior and transfer_discount != 1.0:
        npr, td = int(n_prior), np.float32(transfer_discount)
    else:
        npr, td = 0, np.float32(1.0)
    log_pw = np.log(np.float32(max(prior_weight, 1e-12)))
    return ((n, n_below, ng, nb, m, npr),
            (lo, step, denom, td, _sig_min(ng), _sig_min(nb), log_pw,
             np.float32(prior_weight)))


def _to_device(rows, dtype, device) -> torch.Tensor:
    """(B, k) host rows as one tensor on ``device``; on CUDA the copy comes
    from pinned memory without a device sync."""
    t = torch.from_numpy(np.asarray(rows, dtype=dtype))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _stacked(col) -> torch.Tensor:
    """A per-member column: a (B, ...) tensor as it is, or a sequence of B
    tensors stacked along a new leading axis (one kernel)."""
    return col if isinstance(col, torch.Tensor) else torch.stack(list(col))


def _mixture_logpdf(x, mu, sigma, logw):
    """log pdf of per-dimension mixtures of [0,1]-truncated Gaussians.

    x (..., C, d) evaluation points; mu, sigma, logw (..., N, d) components
    (sigma > 0 even for padding, logw -inf for padding), with the same
    leading axes. Returns (..., C, d). The (..., C, N, d) intermediates are
    materialized: 12.6 MB each at C 192, N 4096, d 4.
    """
    mu_, sig_ = mu[..., None, :, :], sigma[..., None, :, :]
    z = (x[..., :, None, :] - mu_) / sig_
    log_phi = -0.5 * z * z - _HALF_LOG_2PI - torch.log(sig_)
    # truncation mass on [0,1] per component
    a = torch.special.ndtr((1.0 - mu) / sigma)
    b = torch.special.ndtr((0.0 - mu) / sigma)
    log_mass = torch.log(torch.clamp(a - b, 1e-12, 1.0))
    return torch.logsumexp(log_phi - log_mass[..., None, :, :] + logw[..., None, :, :],
                           dim=-2)


# mtpu: hotpath
def ei_scores(cand, good_mu, good_sigma, good_logw, bad_mu, bad_sigma, bad_logw,
              cont_mask, cand_cat_idx, good_cat_logp, bad_cat_logp):
    """EI ranking for TPE: log l(x) − log g(x), shape (..., C).

    Continuous columns use the truncated-Gaussian Parzen mixtures;
    categorical columns (``cont_mask`` 0) look up the per-dim category
    log-probs (..., d, K) at ``cand_cat_idx`` (..., C, d). On a CUDA
    tensor this is the score output of the ``tpe_ei`` kernel (one launch,
    counted in :data:`launches`); on a CPU tensor, :func:`_ei_scores_plain`.
    """
    if cand.device.type == "cpu":
        return _ei_scores_plain(cand, good_mu, good_sigma, good_logw, bad_mu, bad_sigma,
                                bad_logw, cont_mask, cand_cat_idx, good_cat_logp,
                                bad_cat_logp)
    lead, (C, d) = cand.shape[:-2], cand.shape[-2:]
    rows = cand.reshape(-1, C, d)
    B = rows.shape[0]
    fit = TPEFit(*(t.reshape(B, *t.shape[-2:]) for t in (
        good_mu, good_sigma, good_logw, bad_mu, bad_sigma, bad_logw, good_cat_logp,
        bad_cat_logp)))
    cont = torch.broadcast_to(cont_mask > 0, (*lead, d)).reshape(B, d)
    scores, _ = _ei_kernel(fit, rows, None, cand_cat_idx.reshape(B, C, d), cont, n_out=1,
                           n_cand=C, winners=False)
    return scores.reshape(*lead, C)


def _ei_scores_plain(cand, good_mu, good_sigma, good_logw, bad_mu, bad_sigma, bad_logw,
                     cont_mask, cand_cat_idx, good_cat_logp, bad_cat_logp):
    """:func:`ei_scores` in plain PyTorch, on any device."""
    log_l_cont = _mixture_logpdf(cand, good_mu, good_sigma, good_logw)
    log_g_cont = _mixture_logpdf(cand, bad_mu, bad_sigma, bad_logw)
    idx = cand_cat_idx.transpose(-1, -2)                          # (..., d, C)
    log_l_cat = torch.gather(good_cat_logp, -1, idx).transpose(-1, -2)
    log_g_cat = torch.gather(bad_cat_logp, -1, idx).transpose(-1, -2)
    cont = cont_mask[..., None, :] > 0
    log_l = torch.where(cont, log_l_cont, log_l_cat)
    log_g = torch.where(cont, log_g_cont, log_g_cat)
    return torch.sum(log_l - log_g, dim=-1)


def _recency_rows(idx, m, lo, step, denom):
    """Observation-order weights (lineage forgetting ramp), float32, (B, N).

    ``idx`` (N,) row indices; ``m`` (B, 1) ramp lengths and ``lo``,
    ``step``, ``denom`` (B, 1) from :func:`_ramp_scalars`: rows past the
    ramp weigh 1.0, older rows ramp linearly from 1/n up.
    """
    ones = torch.ones((m.shape[0], idx.shape[0]), dtype=torch.float32, device=idx.device)
    ramp = idx.to(torch.float32)[None, :] * step / denom + lo
    return torch.where(idx[None, :] >= m, ones, ramp)


def _recency_weights(n: int, idx, full_weight_num, equal_weight: bool):
    """Observation-order weights of one experiment, float32, (N,): the
    newest ``full_weight_num`` points weigh 1.0, older points ramp linearly
    from 1/n up. ``idx`` is the row index tensor."""
    m, (lo, step, denom) = _ramp_scalars(n, full_weight_num, equal_weight)
    f = _to_device([[lo, step, denom]], np.float32, idx.device)
    mm = torch.full((1, 1), m, dtype=torch.int64, device=idx.device)
    return _recency_rows(idx, mm, f[:, 0:1], f[:, 1:2], f[:, 2:3])[0]


def _fit_set_rows(X, w_sel, count, sig_min, log_pw):
    """Per-dim sorted Parzen components for one (masked) observation
    subset of each member.

    X (B, N, d) unit-cube rows; w_sel (B, N) recency weights, 0.0 outside
    the subset; ``count`` (B,) subset sizes; ``sig_min`` and ``log_pw``
    (B,) the bandwidth floor and the prior's log weight. Returns mu, sigma,
    logw of shape (B, N, d) with the prior pseudo-component at row
    ``count`` and -inf log-weight padding elsewhere.
    """
    B, npad, d = X.shape
    dev = X.device
    row = torch.arange(npad, device=dev)[None, :, None]
    c = count[:, None, None]
    in_set = w_sel > 0.0

    xg = torch.where(in_set[:, :, None], X, _BIG)
    sort_idx = torch.argsort(xg, dim=1, stable=True)
    xs = torch.gather(xg, 1, sort_idx)
    ws = torch.gather(w_sel[:, :, None].expand(B, npad, d), 1, sort_idx)

    valid = row < c
    prev = torch.cat([torch.zeros(B, 1, d, device=dev), xs[:, :-1]], dim=1)
    nxt = torch.cat([xs[:, 1:], torch.full((B, 1, d), _BIG, device=dev)], dim=1)
    left = xs - prev
    right = torch.where(row == c - 1, 1.0 - xs, nxt - xs)
    sig = torch.maximum(torch.maximum(left, right), sig_min[:, None, None])
    sig = torch.clamp(sig, max=1.0)
    sig = torch.where(c == 1, 1.0, sig)           # host rule: single point → 1.0

    mu = torch.where(valid, xs, 0.5)
    sigma = torch.where(valid, sig, 1.0)
    logw = torch.where(valid, torch.log(torch.clamp(ws, min=1e-12)), -torch.inf)
    logw = torch.where(row == c, log_pw[:, None, None], logw)
    return mu, sigma, logw


def _fit_set_device(X, w_sel, count: int, prior_weight: float):
    """:func:`_fit_set_rows` for one experiment: X (N, d), w_sel (N,),
    ``count`` the subset size. Returns mu, sigma, logw of shape (N, d)."""
    f = _to_device([[_sig_min(count), np.log(np.float32(max(prior_weight, 1e-12)))]],
                   np.float32, X.device)
    c = torch.full((1,), int(count), dtype=torch.int64, device=X.device)
    out = _fit_set_rows(X[None], w_sel[None], c, f[:, 0], f[:, 1])
    return tuple(t[0] for t in out)


def _categorical_cdf(u, logits):
    """Categorical draws by inverse CDF: ``u`` (..., C, d) uniforms,
    ``logits`` (..., d, K). Returns (..., C, d) int64 category indices.

    Selection is "first k with cdf[k] >= u", i.e. the count of CDF steps
    below u: the reference's ``sum(u[..., None] > cdf)``, found by a
    binary search (the CDF, a cumulative sum of non-negative terms, never
    decreases in floating point either). A zero-probability category has
    cdf[k] == cdf[k-1] and is never drawn; the clamp guards u ~ 1.0.
    """
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    draw = torch.searchsorted(cdf, u.transpose(-1, -2).contiguous()).transpose(-1, -2)
    return torch.clamp(draw, max=logits.shape[-1] - 1)


def _cat_tables_rows(X, w_sel, n_choices, prior_weight, kmax: int):
    """Re-weighted category frequency tables, (B, d, kmax) log-probs.

    X (B, N, d), w_sel (B, N), n_choices (B, d), prior_weight (B,). The
    counts are a one-hot (B, N, d, kmax) product with the weights, summed
    over N in a fixed order (deterministic on CUDA, unlike a scatter-add).
    """
    k = torch.clamp(n_choices, min=1)                             # (B, d)
    cat_idx = torch.minimum((X * k[:, None, :]).to(torch.int64), (k - 1)[:, None, :])
    col = torch.arange(kmax, device=X.device)
    base = torch.where(col[None, None, :] < k[:, :, None],
                       prior_weight[:, None, None], 0.0)           # (B, d, K)
    onehot = cat_idx[..., None] == col                            # (B, N, d, K)
    counts = base + torch.sum(onehot * w_sel[:, :, None, None], dim=1)
    probs = counts / torch.clamp(counts.sum(dim=2, keepdim=True), min=1e-12)
    return torch.log(torch.clamp(probs, min=1e-12))


def _cat_tables_device(X, w_sel, n_choices, prior_weight: float, kmax: int):
    """:func:`_cat_tables_rows` for one experiment: (d, kmax) log-probs."""
    pw = _to_device([np.float32(prior_weight)], np.float32, X.device)
    return _cat_tables_rows(X[None], w_sel[None], n_choices[None], pw, kmax)[0]


class TPEFit(NamedTuple):
    """The l/g fit of one launch: Parzen components (..., Ng or Nb, d) and
    category log-prob tables (..., d, kmax), with a leading member axis in
    a bucket launch."""

    g_mu: torch.Tensor
    g_sig: torch.Tensor
    g_logw: torch.Tensor
    b_mu: torch.Tensor
    b_sig: torch.Tensor
    b_logw: torch.Tensor
    g_cat: torch.Tensor
    b_cat: torch.Tensor


def _tpe_fit_rows(X, y, ints, floats, n_choices, *, kmax: int, n_good_pad: int,
                  n_bad_pad: int) -> TPEFit:
    """γ-split by objective rank, then the compacted good/bad fits, for
    every member of a bucket.

    X (B, N, d), y (B, N) padded buffers (``+inf`` objectives past each
    member's ``n``); ``ints`` (B, 6) and ``floats`` (B, 8) the members'
    scalars (:func:`_member_scalars`); the good set is fit over
    ``n_good_pad`` rows and the bad set over ``n_bad_pad``.
    """
    B, npad, d = X.shape
    dev = X.device
    idx = torch.arange(npad, device=dev)
    n = ints[:, _I_N:_I_N + 1]
    n_below = ints[:, _I_NBELOW:_I_NBELOW + 1]

    # γ-split by objective rank (padding sorts last via +inf, NaN after it)
    order = torch.argsort(torch.where(idx[None, :] < n, y, torch.inf), dim=1, stable=True)
    w_obs = _recency_rows(idx, ints[:, _I_RAMP:_I_RAMP + 1], floats[:, _F_LO:_F_LO + 1],
                          floats[:, _F_STEP:_F_STEP + 1], floats[:, _F_DENOM:_F_DENOM + 1])
    w_obs = w_obs * torch.where(idx[None, :] < ints[:, _I_NPRIOR:_I_NPRIOR + 1],
                                floats[:, _F_TD:_F_TD + 1], 1.0)

    # compact gather: good rows are order[0:n_below], bad rows follow
    gpos = torch.arange(n_good_pad, device=dev)[None, :]
    gsel = torch.gather(order, 1, torch.clamp(gpos, max=npad - 1).expand(B, n_good_pad))
    w_good = torch.where(gpos < ints[:, _I_NG:_I_NG + 1], torch.gather(w_obs, 1, gsel), 0.0)
    Xg = torch.gather(X, 1, gsel[:, :, None].expand(B, n_good_pad, d))
    bpos = n_below + torch.arange(n_bad_pad, device=dev)[None, :]
    bsel = torch.gather(order, 1, torch.clamp(bpos, max=npad - 1))
    w_bad = torch.where(bpos < n, torch.gather(w_obs, 1, bsel), 0.0)
    Xb = torch.gather(X, 1, bsel[:, :, None].expand(B, n_bad_pad, d))

    log_pw = floats[:, _F_LOGPW]
    g = _fit_set_rows(Xg, w_good, ints[:, _I_NG], floats[:, _F_SIGG], log_pw)
    b = _fit_set_rows(Xb, w_bad, ints[:, _I_NB], floats[:, _F_SIGB], log_pw)
    pw = floats[:, _F_PW]
    g_cat = _cat_tables_rows(Xg, w_good, n_choices, pw, kmax)
    b_cat = _cat_tables_rows(Xb, w_bad, n_choices, pw, kmax)
    return TPEFit(*g, *b, g_cat, b_cat)


def _solo_scalars(X, n, gamma, prior_weight, full_weight_num, n_prior, transfer_discount,
                  equal_weight, n_good_pad):
    ints, floats = _member_scalars(n, gamma, prior_weight, full_weight_num, n_prior,
                                   transfer_discount, equal_weight, n_good_pad)
    return (_to_device([ints], np.int64, X.device), _to_device([floats], np.float32, X.device))


def _tpe_fit(X, y, n: int, n_choices, gamma: float, prior_weight: float,
             full_weight_num, n_prior: int = 0, transfer_discount: float = 1.0, *,
             kmax: int, equal_weight: bool, n_good_pad: int = 0,
             n_bad_pad: int = 0) -> TPEFit:
    """The fit of one experiment (:func:`_tpe_fit_rows` at B = 1).

    X (N, d), y (N,) padded buffers (``+inf`` objectives past ``n``);
    the good set is fit over ``n_good_pad`` rows and the bad set over
    ``n_bad_pad`` (``split_pads``), 0 meaning the full buffer width.
    Returns the fit without its member axis.
    """
    npad = X.shape[0]
    n_good_pad = n_good_pad or npad
    n_bad_pad = n_bad_pad or npad
    ints, floats = _solo_scalars(X, n, gamma, prior_weight, full_weight_num, n_prior,
                                 transfer_discount, equal_weight, n_good_pad)
    fit = _tpe_fit_rows(X[None], y[None], ints, floats, n_choices[None], kmax=kmax,
                        n_good_pad=n_good_pad, n_bad_pad=n_bad_pad)
    return TPEFit(*(t[0] for t in fit))


def _sample_rows(fit: TPEFit, draws, n_choices, cont_mask, kmax: int):
    """Candidates (B, C, d) drawn from each member's l: a mixture component
    per slot and a Gaussian draw around it (one redraw when it leaves
    [0, 1], then a clip), and a category per categorical slot from l's
    table.

    ``draws`` = (u_comp, z_draw, z_redraw, u_cat), each (B, C, d): uniforms
    in [0, 1) and standard normals; n_choices, cont_mask (B, d).
    """
    u_comp, z_draw, z_redraw, u_cat = draws
    k = torch.clamp(n_choices, min=1)
    comp = _categorical_cdf(u_comp, fit.g_logw.transpose(1, 2))
    mu_c = torch.gather(fit.g_mu, 1, comp)
    sig_c = torch.gather(fit.g_sig, 1, comp)
    x = mu_c + sig_c * z_draw
    redraw = mu_c + sig_c * z_redraw
    oob = (x < 0.0) | (x > 1.0)
    x = torch.clamp(torch.where(oob, redraw, x), 1e-6, 1.0 - 1e-6)

    cat_logits = torch.where(
        torch.arange(kmax, device=k.device)[None, None, :] < k[:, :, None],
        fit.g_cat, -torch.inf)
    cats = _categorical_cdf(u_cat, cat_logits)
    cat_vals = (cats.to(torch.float32) + 0.5) / k[:, None, :]
    return torch.where(cont_mask[:, None, :], x, cat_vals)


def _score_rows(fit: TPEFit, cand, n_choices, cont_mask):
    """EI score log l(x) − log g(x) of each member's candidate rows, (B, C),
    in plain PyTorch on any device."""
    k = torch.clamp(n_choices, min=1)
    cand_cat = torch.minimum((cand * k[:, None, :]).to(torch.int64), (k - 1)[:, None, :])
    return _ei_scores_plain(cand, fit.g_mu, fit.g_sig, fit.g_logw, fit.b_mu, fit.b_sig,
                            fit.b_logw, cont_mask.to(torch.float32), cand_cat,
                            fit.g_cat, fit.b_cat)


def ei_argmax_plain(fit: TPEFit, cand, n_choices, cont_mask, *, n_out: int, n_cand: int):
    """:func:`ei_argmax` in plain PyTorch, on any device: the scores of
    :func:`_score_rows` and ``torch.argmax`` over each slot's candidates."""
    scores = _score_rows(fit, cand, n_choices, cont_mask)
    return scores, torch.argmax(scores.reshape(scores.shape[0], n_out, n_cand), dim=2)


def ei_argmax(fit: TPEFit, cand, n_choices, cont_mask, *, n_out: int, n_cand: int):
    """EI scores (B, C) of each member's candidates (B, C, d), C = n_out ×
    n_cand, and each output slot's winner (B, n_out): the index of the
    best of the slot's ``n_cand`` consecutive candidates, the first
    maximum, a NaN counting as the maximum (``torch.argmax``'s rules).

    ``fit`` is the members' :class:`TPEFit`; ``n_choices`` (B, d) int and
    ``cont_mask`` (B, d) bool. On a CUDA tensor: one launch of the
    ``tpe_ei`` kernel, counted in :data:`launches`, or an error. On a CPU
    tensor: :func:`ei_argmax_plain`.
    """
    if cand.device.type == "cpu":
        return ei_argmax_plain(fit, cand, n_choices, cont_mask, n_out=n_out, n_cand=n_cand)
    return _ei_kernel(fit, cand, n_choices, None, cont_mask, n_out=n_out, n_cand=n_cand,
                      winners=True)


# ---------------------------------------------------------------------------
# the CUDA library (built at first use, never at import)

_P = ctypes.c_void_p
_I = ctypes.c_int


#: the most CTAs a cluster takes (the kernel takes 16, but an H100 holds
#: far fewer clusters of 16 at once than of 8: chip_smoke.py times both),
#: and the fewest components (good and bad together) that one CTA of a
#: cluster should get
_EI_MAX_CLUSTER = 8
_EI_MIN_COMPONENTS_PER_CTA = 256
#: warps per CTA at most, and the components of one column each warp
#: should get at least (8 at a time)
_EI_MAX_WARPS = 16
_EI_COMPONENTS_PER_WARP = 64


class EILaunchShape(NamedTuple):
    """How one ``tpe_ei`` launch splits a (member, output slot): a cluster
    of ``cluster`` CTAs, each taking an equal range of both mixtures'
    component rows, with ``warps`` warps that split those components; each
    lane holds ``k`` candidates (a round of 32 k). The grid is B × n_out
    clusters."""
    cluster: int
    k: int
    warps: int


def ei_launch_shape(ng: int, nb: int, n_cand: int) -> EILaunchShape:
    """The launch shape for good and bad pads ``ng``, ``nb`` and ``n_cand``
    candidates per slot. A function of these three alone, never of the
    member count: the kernel's order of additions follows the shape, so a
    bucket row stays the bits of the member's solo row. The cluster doubles
    while each CTA keeps at least ``_EI_MIN_COMPONENTS_PER_CTA`` components,
    so small pads spend no CTAs on ranges of nothing; the warps grow with
    the CTA's components in the same way."""
    cluster = 1
    while (cluster < _EI_MAX_CLUSTER
           and ng + nb >= 2 * cluster * _EI_MIN_COMPONENTS_PER_CTA):
        cluster *= 2
    per_cta = [-(-n // cluster) for n in (ng, nb)]       # rows of each mixture
    comps = sum(-(-rows // 8) * 8 for rows in per_cta)   # staged 8 at a time
    warps = max(1, min(_EI_MAX_WARPS, -(-comps // _EI_COMPONENTS_PER_WARP)))
    return EILaunchShape(cluster, 1 if n_cand <= 32 else 2, warps)


@functools.cache
def build_kernel() -> ctypes.CDLL:
    """Compile (if needed) and load the ``tpe_ei`` kernel's library."""
    from metaopt_tpu_torch.utils import cuda_build

    lib = cuda_build.load("tpe_ei", [cuda_build.CSRC_DIR / "tpe_ei.cu"])
    lib.tpe_ei.argtypes = [_P] * 14 + [_I] * 10 + [ctypes.c_float, _P]
    lib.tpe_ei.restype = ctypes.c_int
    lib.tpe_ei_error_string.argtypes = [_I]
    lib.tpe_ei_error_string.restype = ctypes.c_char_p
    lib.tpe_ei_max_active_clusters.argtypes = [_I] * 6
    lib.tpe_ei_max_active_clusters.restype = ctypes.c_int
    return lib


def _ei_kernel(fit: TPEFit, cand, n_choices, cat_idx, cont, *, n_out: int, n_cand: int,
               winners: bool):
    """One launch of ``tpe_ei``: (scores, winners or None). ``cat_idx``
    (B, C, d), when given, replaces the indices computed from
    ``n_choices``."""
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"the tpe_ei kernel takes CUDA tensors, not {dev}")
    if cand.dim() != 3 or cand.dtype != torch.float32:
        raise ValueError(f"candidates must be float32 (B, C, d), got {cand.dtype} "
                         f"{tuple(cand.shape)}")
    B, C, d = cand.shape
    ng, nb, kmax = fit.g_mu.shape[1], fit.b_mu.shape[1], fit.g_cat.shape[2]
    if n_cand < 1 or n_out * n_cand != C:
        raise ValueError(f"{C} candidates are not {n_out} slots of {n_cand}")
    want = {"g_mu": (B, ng, d), "g_sig": (B, ng, d), "g_logw": (B, ng, d),
            "b_mu": (B, nb, d), "b_sig": (B, nb, d), "b_logw": (B, nb, d),
            "g_cat": (B, d, kmax), "b_cat": (B, d, kmax)}
    for name, shape in want.items():
        t = getattr(fit, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"fit.{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(cont.shape) != (B, d) or cont.dtype != torch.bool or cont.device != dev:
        raise ValueError(f"cont_mask must be bool {(B, d)} on {dev}")
    if cat_idx is None:
        if tuple(n_choices.shape) != (B, d) or n_choices.device != dev:
            raise ValueError(f"n_choices must be {(B, d)} on {dev}")
        n_choices = n_choices.to(torch.int32).contiguous()
    elif tuple(cat_idx.shape) != (B, C, d) or cat_idx.device != dev:
        raise ValueError(f"cat_idx must be {(B, C, d)} on {dev}")
    else:
        cat_idx = cat_idx.to(torch.int64).contiguous()
    lib = build_kernel()
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    win = torch.empty((B, n_out), dtype=torch.int64, device=dev) if winners else None
    if B == 0:
        return scores, win
    ins = [t.contiguous() for t in (cand, *fit)]
    shape = ei_launch_shape(ng, nb, n_cand)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpe_ei(*(t.data_ptr() for t in ins),
                         None if cat_idx is not None else n_choices.data_ptr(),
                         None if cat_idx is None else cat_idx.data_ptr(),
                         cont.contiguous().data_ptr(), scores.data_ptr(),
                         None if win is None else win.data_ptr(),
                         B, d, ng, nb, kmax, n_out, n_cand, shape.cluster, shape.k,
                         shape.warps, _HALF_LOG_2PI, stream)
    if err != 0:
        why = lib.tpe_ei_error_string(err).decode()
        raise RuntimeError(f"tpe_ei: CUDA launch refused or failed with error {err} ({why}) "
                           f"at {shape}")
    launches["tpe_ei"] += 1
    return scores, win


def _batched(fit: TPEFit) -> TPEFit:
    return TPEFit(*(t[None] for t in fit))


def _sample_candidates(fit: TPEFit, draws, n_choices, cont_mask, kmax: int):
    """:func:`_sample_rows` for one experiment's fit: draws (C, d) each;
    returns candidates (C, d)."""
    return _sample_rows(_batched(fit), [t[None] for t in draws], n_choices[None],
                        cont_mask[None], kmax)[0]


def _score_candidates(fit: TPEFit, cand, n_choices, cont_mask):
    """:func:`_score_rows` for one experiment's fit: scores (C,)."""
    return _score_rows(_batched(fit), cand[None], n_choices[None], cont_mask[None])[0]


def _tpe_suggest_rows(
    X, y, ints, floats, draws: Sequence[Tuple[torch.Tensor, ...]], n_choices, cont_mask,
    *, n_cand: int, n_out: int, kmax: int, n_good_pad: int, n_bad_pad: int,
):
    """The body every launch runs, solo (B = 1) or a bucket: fit each
    member once, then for each pool's draws score ``n_cand`` candidates per
    output slot and keep the best. Returns (B, len(draws) * n_out, d)."""
    fit = _tpe_fit_rows(X, y, ints, floats, n_choices, kmax=kmax, n_good_pad=n_good_pad,
                        n_bad_pad=n_bad_pad)
    B, _, d = X.shape
    outs = []
    for pool in draws:
        cand = _sample_rows(fit, pool, n_choices, cont_mask, kmax)
        _, winners = ei_argmax(fit, cand, n_choices, cont_mask, n_out=n_out, n_cand=n_cand)
        picked = torch.gather(cand.reshape(B, n_out, n_cand, d), 2,
                              winners[:, :, None, None].expand(B, n_out, 1, d))
        outs.append(picked[:, :, 0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _tpe_suggest_body(
    X, y, n: int, draws: Sequence[Tuple[torch.Tensor, ...]], n_choices, cont_mask,
    gamma: float, prior_weight: float, full_weight_num, n_prior: int = 0,
    transfer_discount: float = 1.0, *, n_cand: int, n_out: int, kmax: int,
    equal_weight: bool, n_good_pad: int = 0, n_bad_pad: int = 0,
):
    """:func:`_tpe_suggest_rows` for one experiment: X (N, d), y (N,),
    draws of (C, d) tensors. Returns (len(draws) * n_out, d)."""
    npad = X.shape[0]
    n_good_pad = n_good_pad or npad
    n_bad_pad = n_bad_pad or npad
    ints, floats = _solo_scalars(X, n, gamma, prior_weight, full_weight_num, n_prior,
                                 transfer_discount, equal_weight, n_good_pad)
    return _tpe_suggest_rows(
        X[None], y[None], ints, floats, [tuple(t[None] for t in pool) for pool in draws],
        n_choices[None], cont_mask[None], n_cand=n_cand, n_out=n_out, kmax=kmax,
        n_good_pad=n_good_pad, n_bad_pad=n_bad_pad)[0]


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


def _per_member(v, B: int) -> list:
    """A per-member host scalar column: a sequence of B values, or one
    value for every member."""
    if isinstance(v, (list, tuple, np.ndarray)):
        if len(v) != B:
            raise ValueError(f"expected {B} per-member values, got {len(v)}")
        return list(v)
    return [v] * B


def tpe_suggest_fleet(
    X, y, n, count, fit_seed, n_choices, cont_mask, gamma, prior_weight,
    full_weight_num, n_prior=0, transfer_discount=1.0, *, n_cand: int, n_out: int,
    kmax: int, equal_weight: bool, n_good_pad: int, n_bad_pad: int, n_pools: int = 1,
    draws: Optional[List[Tuple[torch.Tensor, ...]]] = None,
):
    """Whole suggest pools for a BUCKET of experiments in one sequence of
    batched launches, on the buffers' device.

    The device columns ``X`` (N, d), ``y`` (N,), ``n_choices`` (d,) and
    ``cont_mask`` (d,) are each a sequence of B per-member tensors (stacked
    here, one kernel per column) or an already stacked (B, ...) tensor; the
    scalar columns (``n``, ``count``, ``fit_seed``, γ, the prior weight,
    ``full_weight_num``, ``n_prior``, ``transfer_discount``) are sequences
    of B host numbers (or one number for all). The statics — pads, widths,
    ``kmax`` and ``equal_weight`` — are the bucket's. Member b's pool p
    draws from ``pool_draws(fit_seed[b], count[b] + p, ...)``, its own
    stream, so row b equals the member's solo :func:`tpe_suggest_fused`.
    ``draws``, when given, replaces the generated draws (one 4-tuple of
    (B, C, d) tensors per pool). Returns (B, n_pools * n_out, d) winners on
    the device.
    """
    Xs = _stacked(X)
    B, _, d = Xs.shape
    dev = Xs.device
    ns, counts, seeds = (_per_member(v, B) for v in (n, count, fit_seed))
    rows = [_member_scalars(*args, equal_weight, n_good_pad) for args in zip(
        ns, _per_member(gamma, B), _per_member(prior_weight, B),
        _per_member(full_weight_num, B), _per_member(n_prior, B),
        _per_member(transfer_discount, B))]
    ints = _to_device([r[0] for r in rows], np.int64, dev)
    floats = _to_device([r[1] for r in rows], np.float32, dev)
    if draws is None:
        C = n_out * n_cand
        draws = []
        for p in range(n_pools):
            per = [pool_draws(seeds[b], counts[b] + p, C, d, dev) for b in range(B)]
            draws.append(tuple(torch.stack([m[k] for m in per]) for k in range(4)))
    return _tpe_suggest_rows(
        Xs, _stacked(y), ints, floats, draws, _stacked(n_choices), _stacked(cont_mask),
        n_cand=n_cand, n_out=n_out, kmax=kmax, n_good_pad=n_good_pad, n_bad_pad=n_bad_pad)


def tpe_suggest_fused(
    X, y, n: int, count: int, fit_seed: int, n_choices, cont_mask, gamma: float,
    prior_weight: float, full_weight_num, n_prior: int = 0,
    transfer_discount: float = 1.0, *, n_cand: int, n_out: int, kmax: int,
    equal_weight: bool, n_good_pad: int = 0, n_bad_pad: int = 0, n_pools: int = 1,
    draws: Optional[List[Tuple[torch.Tensor, ...]]] = None,
):
    """Whole suggest pools of one experiment in one call: the B = 1 case of
    :func:`tpe_suggest_fleet`, on the buffers' device.

    Pool ``p`` draws from ``pool_draws(fit_seed, count + p, ...)``: exactly
    the stream a separate call at stream position ``count + p`` would use,
    so one call with ``n_pools`` pools equals ``n_pools`` single calls bit
    for bit. ``draws``, when given, replaces the generated draws (one
    4-tuple of (C, d) tensors per pool). Returns (n_pools * n_out, d)
    winners on the device.
    """
    npad, d = X.shape
    if draws is None:
        C = n_out * n_cand
        draws = [pool_draws(fit_seed, count + p, C, d, X.device) for p in range(n_pools)]
    return tpe_suggest_fleet(
        X[None], y[None], [n], [count], [fit_seed], n_choices[None], cont_mask[None],
        gamma, prior_weight, full_weight_num, n_prior, transfer_discount,
        n_cand=n_cand, n_out=n_out, kmax=kmax, equal_weight=equal_weight,
        n_good_pad=n_good_pad or npad, n_bad_pad=n_bad_pad or npad, n_pools=len(draws),
        draws=[tuple(t[None] for t in pool) for pool in draws])[0]
