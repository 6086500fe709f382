"""Mixture-of-Experts feed-forward (port of ``metaopt_tpu/models/moe.py``).

Top-k routing with capacity-bounded dispatch: ``router_top_k=1`` is Switch
(the gate is the chosen expert's raw probability), ``router_top_k=2`` is
GShard's top-2 (gates renormalized over the chosen pair). Each expert
processes at most ``cap = max(1, ceil(capacity_factor · k · t / E))``
dispatch items per call: the (token, choice) pairs are scattered into
per-expert slabs (E, cap, d), the expert FFNs run as batched bf16 matrix
products over them, and the results gather back and sum per token. Items
that overflow an expert's queue land in slot ``cap``, which is sliced away:
that choice contributes zero and the caller's residual connection carries
the token. ``capacity_factor <= 0`` selects the dense dispatch (every
expert sees every item, nothing dropped), kept as the oracle the capacity
path is tested against.

The port reproduces the reference where the two frameworks differ:

- ties: ``jax.lax.top_k`` breaks them toward the lower index, which
  ``torch.topk`` does not promise on CUDA; a stable descending sort does;
- dispatch order is token-major, choice-minor (``jnp.repeat(x, k, 0)``),
  and queue positions are a cumulative sum over that order;
- the output is ``y.astype(x.dtype)`` of the f32 layer-norm output, so
  ``x + mlp(y)`` promotes the residual stream from bf16 to f32 from the
  first MoE layer on, as in the reference (a dense FFN keeps it bf16);
- dropout acts on the hidden (E, cap, f), or (E, b, s, f) per choice in
  the dense oracle, with its masks from the layer's draws (``Draws`` /
  ``GivenDraws`` in :mod:`metaopt_tpu_torch.models.transformer`);
- flax sows the switch balance loss into the ``aux_loss`` collection and
  the dropped fraction into ``moe_stats``: the port appends them to the
  lists of those names in the ``aux`` dict its caller passes.

The router is an f32 ``Dense`` (in f32 on the card: the port leaves TF32
off); the expert tables are kept in flax's layout, ``wi`` (E, d, f) and
``wo`` (E, f, d). No hand-written kernel: the reference computes all of
this in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.transformer import _TRUNC_STD, ffn_dropout, global_shape
from metaopt_tpu_torch.parallel import collectives as coll
from metaopt_tpu_torch.parallel.sharding import local_sizes


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index as ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEFeedForward(nn.Module):
    """Under a mesh (``axes``) the experts split over ``ep`` (E/ep tables per
    rank) and each expert's hidden over ``tp``; the tokens are this rank's
    (``dp`` rows × ``sp`` positions), the same on every ``ep``/``tp`` rank.
    Capacity, queue positions, the dropped fraction and the balance loss are
    the reference's global ones: the capacity counts every rank's tokens,
    each item's queue position adds the exclusive prefix of the per-expert
    counts of the items before it on other ranks (in the one-rank dispatch
    order), and the balance loss's fractions and mean probabilities are sums
    over ``dp`` × ``sp``. The dispatch needs no exchange (the ``ep`` ranks
    hold the same tokens, so each scatters into its own experts' slabs); the
    return is an all-gather of the experts' outputs over ``ep``, and the
    backward sums the input's gradient over ``ep`` × ``tp`` (Megatron's f)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dropout: float = 0.0,
                 capacity_factor: float = 1.25, router_top_k: int = 1, axes=None):
        super().__init__()
        self.n_experts, self.d_ff = n_experts, d_ff
        self.dropout = dropout
        self.capacity_factor = capacity_factor
        self.k = max(1, min(int(router_top_k), n_experts))
        self.axes = axes
        local = local_sizes(axes, experts=(n_experts, "ep"), d_ff=(d_ff, "tp")) if axes else \
            {"experts": n_experts, "d_ff": d_ff}
        self.router = nn.Linear(d_model, n_experts)
        # zeros until init_like_flax or a loaded state
        self.wi = nn.Parameter(torch.zeros(local["experts"], d_model, local["d_ff"]))
        self.wo = nn.Parameter(torch.zeros(local["experts"], local["d_ff"], d_model))

    @torch.no_grad()
    def init_tables_like_flax(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the (E, in, out) tables: its fan-in
        counts the expert axis as a receptive field, E · in."""
        for w in (self.wi, self.wo):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    def capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * self.k * tokens / self.n_experts)))

    def _data_size(self) -> int:
        return self.axes.size("dp") * self.axes.size("sp") if self.axes else 1

    def mask_shapes(self, b: int, s: int) -> List[tuple]:
        """The dropout masks one call on a (b, s, d) input draws, in order
        (whole masks: under a mesh each rank keeps its slice)."""
        if self.dropout <= 0.0:
            return []
        f = self.d_ff
        if self.capacity_factor <= 0:
            return [global_shape((self.wi.shape[0], b, s, self.wi.shape[2]), self.axes,
                                 ("ep", "dp", "sp", "tp"))] * self.k
        cap = self.capacity(b * s * self._data_size())
        return [(self.n_experts, cap, f)]

    def _experts(self, xe: torch.Tensor, draws, spec) -> torch.Tensor:
        """This rank's experts as a batched two-matmul FFN in bf16: (E/ep,
        ..., d) → (E/ep, ..., d), f32 partial sums over its ``tp`` slice of
        the hidden when tp > 1 (bf16 otherwise, as one rank computes them)."""
        shape = xe.shape
        flat = xe.reshape(shape[0], -1, shape[-1]).bfloat16()
        h = torch.relu(torch.bmm(flat, self.wi.bfloat16()))
        h = ffn_dropout(h.view(*shape[:-1], -1), self.dropout, draws, self.axes, spec)
        h = h.reshape(shape[0], -1, h.shape[-1])
        if self.axes is None or self.axes.size("tp") == 1:
            return torch.bmm(h, self.wo.bfloat16()).view(shape)
        return torch.bmm(h.float(), self.wo.bfloat16().float()).view(shape)

    def forward(self, x: torch.Tensor, draws=None,
                aux: Optional[Dict[str, List[torch.Tensor]]] = None) -> torch.Tensor:
        axes = self.axes
        data = axes.data if axes else None
        b, s, d = x.shape
        e, k = self.n_experts, self.k
        e_loc = self.wi.shape[0]
        e0 = (axes.index["ep"] if axes else 0) * e_loc
        probs = torch.softmax(F.linear(x.float(), self.router.weight, self.router.bias), -1)
        top_p, top_idx = top_k_lower_index_first(probs, k)                 # (b, s, k)
        gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        onehot_k = F.one_hot(top_idx, e)                                   # (b, s, k, E)
        tokens = b * s * self._data_size()                                 # every rank's

        # switch load balancing: assignment fraction against mean probability,
        # both over every rank's tokens
        frac = coll.all_reduce_(onehot_k.sum((0, 1, 2)).float(), data) / tokens / k
        mean_prob = coll.all_reduce_sum(probs.sum((0, 1)), data) / tokens
        balance = e * (frac * mean_prob).sum()
        if aux is not None:
            aux.setdefault("aux_loss", []).append(balance)

        expert = axes.expert if axes else None
        xin = coll.copy_to_group(x, expert)      # the input's gradient sums over ep × tp
        if self.capacity_factor <= 0:
            # dense oracle: this rank's experts see every (token, choice) copy
            y = torch.zeros((b, s, d), device=x.device)
            for j in range(k):
                oh = onehot_k[:, :, j, e0:e0 + e_loc].permute(2, 0, 1).float()[..., None]
                ye = self._experts(oh * xin.float(), draws, ("ep", "dp", "sp", "tp"))
                y = y + (ye.float() * oh).sum(0) * gates[:, :, j, None]
            return coll.reduce_from_group(y, expert).to(x.dtype)

        # capacity-bounded scatter/gather over t·k items, token-major
        t = b * s
        cap = self.capacity(tokens)
        items = xin.reshape(t, d).repeat_interleave(k, dim=0)              # (t·k, d)
        expf = top_idx.reshape(t * k)
        pos = self._queue_positions(onehot_k, data).gather(0, expf[None])[0]
        kept = pos < cap
        if aux is not None:
            n_kept = coll.all_reduce_(kept.sum().float(), data)
            aux.setdefault("moe_stats", []).append(1.0 - n_kept / (tokens * k))
        # overflowing items land in slot `cap`, sliced away; kept (expert,
        # slot) pairs are unique by the queue positions
        dst = torch.where(kept, pos, cap)
        buf = x.new_zeros((e, cap + 1, d)).index_put((expf, dst), items)
        out = self._experts(buf[e0:e0 + e_loc, :cap], draws, ("ep", None, "tp"))
        if axes is not None:
            out = coll.reduce_from_group(out, axes.group("tp")).bfloat16()
            out = coll.gather_from_group(out, axes.group("ep"), 0)         # (E, cap, d)
        # a row gather whose backward adds into rows (index_add): advanced
        # indexing's backward sorts the indices and accumulates repeats one by
        # one, and every dropped item reads slot cap − 1 of its expert
        y = out.reshape(e * cap, d).index_select(
            0, expf * cap + dst.clamp_max(cap - 1)).float()
        y = torch.where(kept[:, None], y, 0.0) * gates.reshape(t * k, 1)
        return y.view(t, k, d).sum(1).view(b, s, d).to(x.dtype)

    def _queue_positions(self, onehot_k: torch.Tensor, data) -> torch.Tensor:
        """(E, t·k) queue position of each of this rank's items within its
        expert: a cumulative sum in dispatch order (token-major over rows,
        positions and choices), laid out with the items as the inner axis
        (an outer-axis scan runs E threads over t·k rows on CUDA), plus the
        items that come before them on other ranks: earlier ``dp`` shards,
        earlier rows of this shard, and this row's earlier ``sp`` slices."""
        b, s, k, e = onehot_k.shape
        rows = onehot_k.reshape(b, s * k, e).transpose(1, 2).contiguous()  # (b, E, s·k)
        pos = torch.cumsum(rows, 2) - 1
        counts = rows.sum(2)                                               # (b, E)
        axes = self.axes
        if axes is None or data is None:
            before = torch.cumsum(counts, 0) - counts
        else:
            dp, sp = axes.size("dp"), axes.size("sp")
            c = coll.all_gather_cat(counts[None], data, 0).view(dp, sp, b, e)
            i, j = axes.index["dp"], axes.index["sp"]
            row_tot = c[i].sum(0)                                          # (b, E)
            before = (c[:i].sum((0, 1, 2))[None] + torch.cumsum(row_tot, 0) - row_tot
                      + c[i, :j].sum(0))
        return (pos + before[:, :, None]).permute(1, 0, 2).reshape(e, b * s * k)
