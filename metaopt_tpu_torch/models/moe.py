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

from metaopt_tpu_torch.models.transformer import _TRUNC_STD, ffn_dropout


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index as ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_experts: int, dropout: float = 0.0,
                 capacity_factor: float = 1.25, router_top_k: int = 1):
        super().__init__()
        self.n_experts, self.d_ff = n_experts, d_ff
        self.dropout = dropout
        self.capacity_factor = capacity_factor
        self.k = max(1, min(int(router_top_k), n_experts))
        self.router = nn.Linear(d_model, n_experts)
        # zeros until init_like_flax or a loaded state
        self.wi = nn.Parameter(torch.zeros(n_experts, d_model, d_ff))
        self.wo = nn.Parameter(torch.zeros(n_experts, d_ff, d_model))

    @torch.no_grad()
    def init_tables_like_flax(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the (E, in, out) tables: its fan-in
        counts the expert axis as a receptive field, E · in."""
        for w in (self.wi, self.wo):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    def capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * self.k * tokens / self.n_experts)))

    def mask_shapes(self, b: int, s: int) -> List[tuple]:
        """The dropout masks one call on a (b, s, d) input draws, in order."""
        if self.dropout <= 0.0:
            return []
        if self.capacity_factor <= 0:
            return [(self.n_experts, b, s, self.d_ff)] * self.k
        return [(self.n_experts, self.capacity(b * s), self.d_ff)]

    def _experts(self, xe: torch.Tensor, draws) -> torch.Tensor:
        """The batched-over-experts two-matmul FFN in bf16: (E, ..., d) →
        (E, ..., d)."""
        shape = xe.shape
        flat = xe.reshape(shape[0], -1, shape[-1]).bfloat16()
        h = torch.relu(torch.bmm(flat, self.wi.bfloat16()))
        h = ffn_dropout(h.view(*shape[:-1], -1), self.dropout, draws)
        out = torch.bmm(h.reshape(shape[0], -1, self.d_ff), self.wo.bfloat16())
        return out.view(shape)

    def forward(self, x: torch.Tensor, draws=None,
                aux: Optional[Dict[str, List[torch.Tensor]]] = None) -> torch.Tensor:
        b, s, d = x.shape
        e, k = self.n_experts, self.k
        probs = torch.softmax(F.linear(x.float(), self.router.weight, self.router.bias), -1)
        top_p, top_idx = top_k_lower_index_first(probs, k)                 # (b, s, k)
        gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        onehot_k = F.one_hot(top_idx, e)                                   # (b, s, k, E)

        # switch load balancing: assignment fraction against mean probability
        frac = onehot_k.sum(2).float().mean((0, 1)) / k
        balance = e * (frac * probs.mean((0, 1))).sum()
        if aux is not None:
            aux.setdefault("aux_loss", []).append(balance)

        if self.capacity_factor <= 0:
            # dense oracle: every expert sees every (token, choice) copy
            y = torch.zeros((b, s, d), device=x.device)
            for j in range(k):
                oh = onehot_k[:, :, j].permute(2, 0, 1).float()[..., None]  # (E, b, s, 1)
                ye = self._experts(oh * x.float(), draws)
                y = y + (ye.float() * oh).sum(0) * gates[:, :, j, None]
            return y.to(x.dtype)

        # capacity-bounded scatter/gather over t·k items, token-major
        t = b * s
        cap = self.capacity(t)
        items = x.reshape(t, d).repeat_interleave(k, dim=0)                # (t·k, d)
        expf = top_idx.reshape(t * k)
        # queue position: a cumulative sum along the items, laid out as the
        # inner axis (an outer-axis scan runs E threads over t·k rows on CUDA)
        pos = (torch.cumsum(onehot_k.reshape(t * k, e).t().contiguous(), 1) - 1).gather(
            0, expf[None])[0]
        kept = pos < cap
        if aux is not None:
            aux.setdefault("moe_stats", []).append(1.0 - kept.float().mean())
        # overflowing items land in slot `cap`, sliced away; kept (expert,
        # slot) pairs are unique by the cumulative sum
        dst = torch.where(kept, pos, cap)
        buf = x.new_zeros((e, cap + 1, d)).index_put((expf, dst), items)
        out = self._experts(buf[:, :cap], draws)                          # (E, cap, d)
        # a row gather whose backward adds into rows (index_add): advanced
        # indexing's backward sorts the indices and accumulates repeats one by
        # one, and every dropped item reads slot cap − 1 of its expert
        y = out.reshape(e * cap, d).index_select(
            0, expf * cap + dst.clamp_max(cap - 1)).float()
        y = torch.where(kept[:, None], y, 0.0) * gates.reshape(t * k, 1)
        return y.view(t, k, d).sum(1).view(b, s, d).to(x.dtype)
