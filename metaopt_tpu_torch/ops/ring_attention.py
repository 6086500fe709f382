"""Ring attention: sequence-parallel attention over a mesh axis (port of
``metaopt_tpu/ops/ring_attention.py``).

The sequence is split over the ``sp`` ranks; each rank keeps its queries
and the K/V shards go round the ring, one hop at a time
(:func:`~metaopt_tpu_torch.parallel.collectives.ring_hop`), while the rank
folds each shard it holds into online-softmax statistics. ``sp − 1`` hops
carry every shard past every rank; the last fold is peeled off, so no
hop is paid after it. The full (S, S) scores never exist on any rank.

The per-hop fold is plain PyTorch in f32, as the reference's is XLA
(``online_softmax_fold``), not a Pallas kernel; running K1 per hop and
merging by the logsumexp is queued as a ``perf_opt`` item. The backward is
autograd's: the same ring in reverse, each hop's transpose sending the
gradient back. Fully masked rows give zeros, as the kernels' do.

Dropout uses the kernels' Philox keep bits at the global (row, column) of
each score, with the seed made distinct per (dp, tp) coordinate
(:func:`~metaopt_tpu_torch.ops.attention.shard_philox`), or given keep
bits (CPU tests).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metaopt_tpu_torch.ops.attention import _NEG_BIG, keep_prob, philox_keep, shard_philox
from metaopt_tpu_torch.parallel.collectives import ring_hop
from metaopt_tpu_torch.parallel.mesh import axes_group, axis_index, axis_size


def check_seq_axis(mesh, seq_axis: str) -> int:
    if seq_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {seq_axis!r} axis: "
                         f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return axis_size(mesh, seq_axis)


def shard_seq(x: torch.Tensor, mesh, seq_axis: str = "sp", dim: int = 1) -> torch.Tensor:
    """This rank's slice of ``x`` along the sequence ``dim``; lengths must
    divide by the axis (pad upstream)."""
    sp = check_seq_axis(mesh, seq_axis)
    if x.shape[dim] % sp:
        raise ValueError(f"S={x.shape[dim]} must divide seq axis {sp}")
    n = x.shape[dim] // sp
    return x.narrow(dim, axis_index(mesh, seq_axis) * n, n)


def online_softmax_fold(s, v, m, l, acc, drop=None, keep: float = 1.0):
    """Fold one masked score tile into the running statistics (the
    reference's ``online_softmax_fold``): l sums the probabilities before
    dropout, acc takes the kept ones over keep_prob."""
    m_new = torch.clamp_min(torch.maximum(m, s.amax(-1, keepdim=True)), 0.5 * _NEG_BIG)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    if drop is not None:
        p = torch.where(drop, p / keep, 0.0)
    return m_new, l_new, alpha * acc + p @ v


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    seq_axis: str = "sp",
    batch_axis: Optional[str] = "dp",
    head_axis: Optional[str] = "tp",
    dropout_rate: float = 0.0,
    philox: Optional[Tuple[int, int]] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One rank's share of sequence-parallel attention.

    q: (b, Sq/sp, h, D), this rank's queries, pre-scaled; k, v: (b, Sk/sp,
    h, D), this rank's keys and values; mask: optional (b, Sq/sp, Sk),
    True/nonzero = attend, this rank's rows over every key column; ``keep``
    (b, h, Sq/sp, Sk) bool, given keep bits. b and h are this rank's dp and
    tp slices. Returns (b, Sq/sp, h, D) in q's dtype."""
    sp = check_seq_axis(mesh, seq_axis)
    if dropout_rate > 0.0 and (philox is None) == (keep is None):
        raise ValueError("dropout_rate > 0 needs one of a philox pair or keep bits")
    group = axes_group(mesh, (seq_axis,))
    my = axis_index(mesh, seq_axis)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt = q.transpose(1, 2).float()
    kp = keep_prob(dropout_rate)
    if dropout_rate > 0.0 and philox is not None:
        coord = [axis_index(mesh, a) for a in (batch_axis, head_axis) if a]
        seed, offset = shard_philox(philox, coord)
        rows = range(my * sq, (my + 1) * sq)

    m = torch.full((b, h, sq, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    kv = (k, v)
    for i in range(sp):
        # hop i holds the shard that started i ranks back
        src = (my - i) % sp
        cols = slice(src * sk, (src + 1) * sk)
        kt, vt = (t.transpose(1, 2).float() for t in kv)
        s = qt @ kt.transpose(-1, -2)
        if mask is not None:
            s = torch.where(mask[:, None, :, cols] != 0, s, _NEG_BIG)
        drop = None
        if dropout_rate > 0.0:
            if keep is not None:
                drop = keep[:, :, :, cols].to(q.device)
            else:
                drop = philox_keep(seed, offset, range(b * h), rows, range(cols.start, cols.stop),
                                   dropout_rate, device=q.device).view(b, h, sq, sk)
        m, l, acc = online_softmax_fold(s, vt, m, l, acc, drop, kp)
        if i < sp - 1:   # the last fold is peeled: no hop after it
            kv = (ring_hop(kv[0], group), ring_hop(kv[1], group))
    out = torch.where(l > 0, acc / torch.clamp_min(l, 1e-30), 0.0)
    return out.to(q.dtype).transpose(1, 2)
