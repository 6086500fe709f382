"""Collectives with gradients: the port's ``shard_map`` + ``lax`` collectives.

JAX differentiates ``ppermute``, ``all_to_all`` and ``psum`` by their
transposes; here each is a :class:`torch.autograd.Function` whose backward
is the transposed collective:

- :func:`ring_hop` — ``lax.ppermute`` one step round a ring: send to the
  next rank and receive from the previous one, in one
  ``batch_isend_irecv``; the backward hops the other way;
- :func:`all_to_all` — ``lax.all_to_all(tiled=True)``: split one axis over
  the ranks and concatenate what arrives along another; the backward swaps
  the two axes;
- :func:`copy_to_group` / :func:`reduce_from_group` — Megatron's f and g:
  identity forward with an all-reduce backward, and an all-reduce forward
  with an identity backward (the tensor-parallel dense layers);
- :func:`all_reduce_sum` — ``psum`` of a value every rank goes on to use:
  an all-reduce both ways;
- :func:`gather_from_group` — an all-gather whose consumers are replicated:
  the backward keeps this rank's slice of the gradient;
- :func:`any_flag` — the global OR of a per-rank flag.

``group=None`` (a one-rank axis) makes each of them the identity. Every
rank of a group must issue the same collectives in the same order, the
backward's included: an output that reaches the loss on some ranks and not
on others would leave its transposed collective waiting forever (the
process group's timeout then fails the call).

Ranks that share a GPU use ``gloo``, whose ``batch_isend_irecv`` fails on
CUDA tensors (torch 2.11 + CUDA 12.8 on the H100: ``writev: Bad address``
in the TCP transport; all-reduce, broadcast, all-gather and all-to-all run
on them). So the ring hop alone copies through host memory there,
explicitly, and :data:`host_bytes` counts the bytes it copied (both
directions).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

#: bytes copied device → host → device per collective since the last reset
host_bytes: Dict[str, int] = {}
#: calls per collective since the last reset
calls: Dict[str, int] = {}


def reset_counts() -> None:
    host_bytes.clear()
    calls.clear()


def _count(op: str) -> None:
    calls[op] = calls.get(op, 0) + 1


def group_ranks(group) -> List[int]:
    return dist.get_process_group_ranks(group)


# ---------------------------------------------------------------------------
# the collectives, no gradient


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (bf16 is reduced in f32)."""
    if group is None:
        return t
    _count("all_reduce")
    if t.dtype == torch.bfloat16:
        f = t.float()
        dist.all_reduce(f, op=op, group=group)
        return t.copy_(f)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in group rank order."""
    if group is None:
        return t
    _count("all_gather")
    t = t.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast from global rank ``src``."""
    _count("broadcast")
    dist.broadcast(t, src, group=group)
    return t


def _all_to_all(t: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(t.shape)} does not "
                         f"split {n} ways")
    _count("all_to_all")
    # chunk j of the split axis goes to rank j; what arrives from rank j is
    # chunk j of the concat axis
    send = torch.stack(t.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_dim)


def _ring(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    ranks = group_ranks(group)
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    _count("ring_hop")
    t = t.contiguous()
    # gloo's point-to-point refuses CUDA tensors: through the host, counted
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        host_bytes["ring_hop"] = host_bytes.get("ring_hop", 0) + 2 * t.numel() * t.element_size()
    src = t.cpu() if staged else t
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(me - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if staged else recv


# ---------------------------------------------------------------------------
# autograd


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (dim, x.shape[dim], group_ranks(group).index(dist.get_rank()))
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        dim, size, me = ctx.args
        return g.narrow(dim, me * size, size), None, None


def ring_hop(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` from the previous rank of the ring (this rank's goes to the next)."""
    return x if group is None else _RingHop.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group, split_dim, concat_dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


def any_flag(flag: bool, group=None, device=None) -> bool:
    """The OR of every rank's ``flag`` (a max all-reduce of one integer)."""
    if not (dist.is_available() and dist.is_initialized()):
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=device if device is not None else "cpu")
    if group is None and dist.get_world_size() == 1:
        return bool(flag)
    _count("all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())

