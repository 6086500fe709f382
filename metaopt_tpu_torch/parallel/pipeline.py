"""Pipeline parallelism: GPipe and interleaved virtual-stage schedules (port
of ``metaopt_tpu/parallel/pipeline.py``).

Each rank along the ``pp`` axis owns ``virtual_stages`` stage slices of a
stack with a leading logical-stage dimension P·V: rank d owns stages d,
P + d, 2P + d, …. Microbatches flow stage to stage round the ring: every
tick each rank applies one stage slice to the activation it holds and hands
the result one hop on
(:func:`~metaopt_tpu_torch.parallel.collectives.ring_hop`; the hop from
rank P − 1 back to rank 0 carries the activation into its next virtual
round, one tick later, with no buffering).

For M microbatches over P ranks, ``virtual_stages=1`` is GPipe (M + P − 1
ticks, bubble (P − 1)/(M + P − 1)) and V > 1 the interleaved schedule
(M·V + P − 1 ticks, bubble (P − 1)/(M·V + P − 1); :func:`bubble_fraction`).
``pre_fn`` (the token embedding) runs as part of logical stage 0 on each
fed microbatch and ``post_fn`` (the readout) on the last stage's outputs.

The end is a masked sum over ``pp``: only the last rank holds the outputs,
and every rank returns them. Autograd differentiates the ticks into the
reverse schedule (each hop's transpose sends the gradient back), after the
full forward, as the reference's scan-VJP does — not 1F1B. Every rank
issues the same hops in the same order, in the backward too: each hop's
output reaches the loss on every rank (a rank that feeds a fresh
microbatch instead selects with ``torch.where``, whose backward still
answers the hop with zeros). A rank's gradients cover its own stages (and
the ends it ran); sum them over ``pp`` for the whole stack's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from metaopt_tpu_torch.parallel.collectives import reduce_from_group, ring_hop
from metaopt_tpu_torch.parallel.mesh import axes_group, axis_index, axis_size, mesh_shape
from metaopt_tpu_torch.parallel.sharding import pp_slice


def bubble_fraction(n_stages: int, n_microbatches: int, virtual_stages: int = 1) -> float:
    """Idle fraction of the schedule: (P−1)/(M·V + P − 1)."""
    return (n_stages - 1) / (n_microbatches * virtual_stages + n_stages - 1)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pp",
    batch_axis: Optional[str] = "dp",
    n_microbatches: Optional[int] = None,
    virtual_stages: int = 1,
    pre_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
    pre_params: Any = None,
    post_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
    post_params: Any = None,
) -> torch.Tensor:
    """y = post(stage_{PV−1}(…stage_0(pre(x)))) with the stages over ``pp``.

    ``stage_params``: a tree whose leaves have a leading dimension P·V (one
    slice per logical stage, the whole stack on every rank; this rank uses
    its own). ``stage_fn(params_s, h) -> h`` keeps the trunk activation's
    shape; ``pre_fn``/``post_fn`` map into and out of it. ``x``: this rank's
    ``batch_axis`` shard of the batch, a multiple of ``n_microbatches``
    (default P) rows; with V > 1, ``n_microbatches`` a multiple of P (the
    interleaved schedule feeds groups of P). Returns this rank's shard of y
    (like ``post_fn``'s output, or like x), the same on every ``pp`` rank.
    """
    if axis not in mesh_shape(mesh):
        raise ValueError(f"mesh has no {axis!r} axis: {mesh_shape(mesh)}")
    n_stages = axis_size(mesh, axis)
    v_stages = int(virtual_stages)
    n_logical = n_stages * v_stages
    leads = {leaf.shape[0] if leaf.dim() else None for leaf in tree_leaves(stage_params)}
    if leads != {n_logical}:
        raise ValueError(
            f"stage_params leading dims {sorted(leads, key=str)} must all equal {axis} mesh "
            f"size × virtual_stages = {n_logical} (None = scalar leaf)")
    m = n_microbatches or n_stages
    if v_stages > 1 and m % n_stages:
        raise ValueError(
            f"interleaved schedule feeds microbatches in groups of {n_stages}: "
            f"n_microbatches {m} must be a multiple of {n_stages}")
    if x.shape[0] % m:
        raise ValueError(f"per-shard batch {x.shape[0]} must be a multiple of "
                         f"n_microbatches {m}")
    d = axis_index(mesh, axis)
    group = axes_group(mesh, (axis,))
    params_v = tree_map(lambda a: pp_slice(a, n_stages, d), stage_params)   # (V, ...)
    micro = x.reshape(m, x.shape[0] // m, *x.shape[1:])

    def embed(mb):
        return pre_fn(pre_params, mb) if pre_fn is not None else mb

    ticks = m * v_stages + n_stages - 1
    # the last rank finishes chunk (g, V−1, j) of microbatch g·P + j at tick
    # (P−1) + g·V·P + (V−1)·P + j
    if v_stages > 1:
        t_out = [n_stages - 1 + (v_stages - 1) * n_stages + g * v_stages * n_stages + j
                 for g in range(m // n_stages) for j in range(n_stages)]
    else:
        t_out = [n_stages - 1 + i for i in range(m)]
    held, outs = None, {}
    h0 = None
    for t in range(ticks):
        # rank d works on chunk (g, v, j) = microbatch g·P + j at virtual
        # round v, where t = d + g·V·P + v·P + j (clipped at the ends)
        lt = min(max(t - d, 0), m * v_stages - 1)
        r = lt % (v_stages * n_stages)
        v = r // n_stages
        micro_idx = (lt // (v_stages * n_stages)) * n_stages + r % n_stages
        if d == 0 and v == 0:
            inp = embed(micro[micro_idx])
            if held is not None:   # the held activation still answers its hop
                inp = torch.where(torch.tensor(True, device=inp.device), inp, held)
        elif held is not None:
            inp = held
        else:
            if h0 is None:
                with torch.no_grad():
                    h0 = torch.zeros_like(embed(micro[0]))
            inp = h0
        out = stage_fn(tree_map(lambda a: a[v], params_v), inp)
        if t in t_out:
            outs[t] = out
        if t < ticks - 1:   # the last tick's hop would carry nothing onward
            held = ring_hop(out, group)
    y = torch.cat([outs[t] for t in t_out], 0)
    if post_fn is not None:
        y = post_fn(post_params, y)
    # only the last rank holds real outputs; every rank returns them
    y = torch.where(torch.tensor(d == n_stages - 1, device=y.device), y, torch.zeros_like(y))
    return reduce_from_group(y, group)
