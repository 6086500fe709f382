"""Transformer-base seq2seq — the demo trial workload, on PyTorch.

Port of ``metaopt_tpu/models/transformer.py``: an
encoder-decoder Transformer-base (d_model 512, 8 heads, 6+6 layers, d_ff
2048) trained on the synthetic translation-shaped task. Every attention
call goes through :func:`metaopt_tpu_torch.ops.attention.flash_attention`,
whose forward and backward are the Hopper kernels.

The port matches the reference's numerics where the two frameworks differ:

- dense layers cast input, f32 weight and bias to bf16 (flax
  ``Dense(dtype=bf16)``), so the residual stream is bf16;
- layer norms compute in f32 with epsilon 1e-6 (flax's default);
- q is scaled by 1/sqrt(d_head) before the kernel. The reference's
  ``bf16 / np.float64`` promotes q to f32 there; the port keeps q in bf16,
  which is exact when sqrt(d_head) is a power of two (d_head 64);
- the attention kernels take bf16 operands on the tensor cores and keep
  softmax statistics and accumulators in f32, where the reference's
  kernels compute in f32: they round P to bf16 for dV, and split P (for
  O) and dS (for dK and dQ) into two bf16 terms, head + tail;
- the embedding lookup is bf16 and the tied readout is
  ``bf16(y) @ f32 embedding`` in f32, as jnp promotes it;
- init mirrors flax in distribution: truncated-normal lecun for the dense
  kernels, normal(1.0) for the embedding, normal(0.02) for the positions,
  zero biases.

- dropout (rate ``dropout``, the reference's default 0.1) applies in
  training only: attention dropout inside the kernels K1–K3 (a Philox
  seed per call, drawn from a CPU generator), and the feed-forward's
  ``nn.Dropout`` after the relu as plain PyTorch (``x / keep_prob`` or 0,
  as in the reference it is plain XLA). Every draw of a train step goes
  through one seam, :class:`Draws` (generators seeded from (seed, step),
  as the reference folds the step into its key) or :class:`GivenDraws`
  (the tests' and ``chip_smoke.py``'s injected masks);
- each layer's draws are taken before the layer runs (:class:`LayerDraws`)
  and replayed inside it, so that ``remat`` (a ``torch.autograd.Function``
  per layer, :class:`_Remat`; flax's ``nn.remat``) recomputes the forward's
  dropout exactly: the generators are not pure, as flax's keys are, and a
  recompute drawing afresh would give the backward other masks than the
  forward. Under remat K1 runs twice per layer and train step;
- ``n_experts > 0`` turns every FFN into a top-k-routed MoE
  (:mod:`metaopt_tpu_torch.models.moe`), whose switch balance loss joins the
  loss with weight ``moe_aux_weight`` (0.01), as the reference's
  ``aux_loss`` collection does;
- the loss routes through the blocked cross-entropy
  (:mod:`metaopt_tpu_torch.ops.xent`) where the f32 logits would take at
  least 4 GiB (:func:`blocked_xent_enabled`, the reference's threshold, so
  the same shapes take the same route); the model then returns its
  pre-readout features and the (B, T, V) logits never exist;
- the optimizer is ``optax.adamw`` over the reference's schedule, written
  in ``torch._foreach`` ops (:class:`ScheduledAdamW`): ``torch.optim``'s
  first optimizer imports ``torch._dynamo``, ~11 s per trial process.
  ``torch.utils.checkpoint`` imports it at its first call too, so remat is
  a Function of the port's own and imports nothing.

:func:`params_from_flax` converts the reference's parameter tree (this
Transformer's or the decoder-only LM's) so both packages compute the same
function in the tests. Trial checkpoints (``train_and_eval(restore_dir=...,
save_dir=...)``) are the port's own format
(:mod:`metaopt_tpu_torch.models.checkpoint`), not orbax; on a mesh each
rank saves and restores its own slice.

With more than one trial device the model runs on a mesh (the reference's
GSPMD shardings, cut explicitly by :mod:`metaopt_tpu_torch.parallel`):
batch over ``dp``; heads and the feed-forward hidden over ``tp``
(Megatron's column split of q/k/v and wi, row split of out and wo, the
row products summed in f32 and rounded to bf16 once); the sequence over
``sp`` (ring or Ulysses attention, the rest of the layer per position);
experts over ``ep`` (:mod:`metaopt_tpu_torch.models.moe`). Each rank's
loss is its share of the one-rank loss and the gradients are summed over
``dp`` × ``sp`` (:func:`make_train_step`).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.checkpoint import has_state, restore_state, save_state
from metaopt_tpu_torch.models.data import synthetic_seq2seq
from metaopt_tpu_torch.ops.attention import draw_seed, flash_attention, sharded_flash_attention
from metaopt_tpu_torch.parallel import collectives as coll
from metaopt_tpu_torch.parallel import launch
from metaopt_tpu_torch.parallel.mesh import (active_mesh, make_mesh, mesh_shape, mesh_sizes,
                                             trial_devices, use_mesh)
from metaopt_tpu_torch.parallel.sharding import MeshAxes, local_sizes, shard_batch, shard_params
from metaopt_tpu_torch.ops.xent import blocked_softmax_xent, pick_block_v
from metaopt_tpu_torch.utils.device import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm default
# a trial checkpoint: one file in the trial's directory, trees "params" and
# "opt_state", published in one rename (models/checkpoint.py)
CKPT_FILE = "state"
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_dense_like_flax(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``Dense``'s defaults: a lecun-normal kernel truncated to two
    standard deviations, and a zero bias."""
    std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    nn.init.zeros_(layer.bias)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=bf16)``: input, kernel and bias all cast to bf16;
    the product is rounded to bf16 before the bias add, as in flax."""
    return F.linear(x.bfloat16(), layer.weight.bfloat16()) + layer.bias.bfloat16()


def _dense_col(layer: nn.Linear, x: torch.Tensor, axes) -> torch.Tensor:
    """A column-split (``tp``) dense layer: Megatron's f on the input
    (identity forward, gradient summed over ``tp``), then this rank's
    output columns."""
    return _dense(layer, coll.copy_to_group(x, axes.group("tp") if axes else None))


def _dense_row(layer: nn.Linear, x: torch.Tensor, axes) -> torch.Tensor:
    """A row-split (``tp``) dense layer: this rank's f32 partial product of
    the bf16 operands, summed over ``tp`` (Megatron's g), rounded to bf16
    once, then the bias — the one-rank ``_dense`` but for the summation
    order."""
    group = axes.group("tp") if axes else None
    if group is None:
        return _dense(layer, x)
    part = F.linear(x.bfloat16().float(), layer.weight.bfloat16().float())
    return coll.reduce_from_group(part, group).bfloat16() + layer.bias.bfloat16()


def _check_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    if tuple(mask.shape) != tuple(shape):
        raise ValueError(f"given mask of shape {tuple(mask.shape)}, the layer needs "
                         f"{tuple(shape)}")
    return mask


class Draws:
    """Every random draw of one train step: the attention kernels' Philox
    seeds from a CPU generator (a draw costs no device sync) and the
    feed-forward dropout masks from a generator on the model's device, both
    seeded from (``seed``, ``step``)."""

    def __init__(self, seed: int, step: int, device):
        # mixed into one key: a CPU generator seeds from its low 32 bits only
        key = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
        self.attention = torch.Generator().manual_seed(key)
        self.device = torch.device(device)
        self._ffn = torch.Generator(device=self.device).manual_seed(key)

    def attention_draw(self) -> Dict[str, Any]:
        """``flash_attention``'s dropout input for one call: a Philox pair."""
        return {"philox": draw_seed(self.attention)}

    def ffn_keep(self, shape, keep: float) -> torch.Tensor:
        return torch.rand(shape, generator=self._ffn, device=self.device) < keep


class GivenDraws:
    """Draws fixed in advance: ``ffn_masks``, one keep mask per feed-forward
    dropout in the order they run (encoder layers, then decoder layers; a
    MoE layer's dense oracle draws one per routing choice), and the
    attention seeds from a CPU generator seeded with ``attention_seed`` or,
    where ``attention_keep`` is given (CPU only), one (B, H, Sq, Sk) keep
    mask per attention call in the order they run (the tests inject the
    reference's own bits)."""

    def __init__(self, ffn_masks: Sequence[Any], attention_seed: int, device,
                 attention_keep: Optional[Sequence[Any]] = None):
        dev = torch.device(device)
        self._masks = [torch.as_tensor(np.asarray(m), dtype=torch.bool).to(dev)
                       for m in ffn_masks]
        self._next = 0
        self.attention = torch.Generator().manual_seed(int(attention_seed))
        self._keep = None if attention_keep is None else [
            torch.as_tensor(np.asarray(m), dtype=torch.bool).to(dev) for m in attention_keep]

    def attention_draw(self) -> Dict[str, Any]:
        if self._keep is None:
            return {"philox": draw_seed(self.attention)}
        return {"keep": self._keep.pop(0)}

    def ffn_keep(self, shape, keep: float) -> torch.Tensor:
        mask = self._masks[self._next]
        self._next += 1
        return _check_mask(mask, shape)


class LayerDraws:
    """One layer's draws, taken from a step's draws before the layer runs:
    the attention inputs of its ``n_attention`` calls and its feed-forward
    masks. Each :meth:`replay` hands them out again in the same order, so a
    recompute under remat sees the forward's masks and seeds."""

    def __init__(self, attention: Sequence[Dict[str, Any]], ffn: Sequence[torch.Tensor]):
        self._attention, self._ffn = list(attention), list(ffn)
        self._a = self._f = 0

    @classmethod
    def take(cls, draws, n_attention: int, mask_shapes: Sequence[tuple],
             keep: float) -> "LayerDraws":
        return cls([draws.attention_draw() for _ in range(n_attention)],
                   [draws.ffn_keep(shape, keep) for shape in mask_shapes])

    def replay(self) -> "LayerDraws":
        return LayerDraws(self._attention, self._ffn)

    def attention_draw(self) -> Dict[str, Any]:
        self._a += 1
        return self._attention[self._a - 1]

    def ffn_keep(self, shape, keep: float) -> torch.Tensor:
        self._f += 1
        return _check_mask(self._ffn[self._f - 1], shape)


def global_shape(shape, axes, spec) -> tuple:
    """The whole tensor's shape of a local slice cut along ``spec``."""
    if axes is None:
        return tuple(shape)
    return tuple(n * (axes.size(a) if a else 1) for n, a in zip(shape, spec))


def ffn_dropout(h: torch.Tensor, rate: float, draws, axes=None,
                spec=("dp", "sp", "tp")) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode (``draws`` given): kept activations
    over keep_prob, the rest 0. flax divides the bf16 activations by its
    weak-typed keep_prob, which takes their dtype first: keep_prob is
    rounded to bf16 before the division. Under a mesh the mask is drawn
    whole, as one rank draws it, and this rank keeps its slice (``spec``
    names the axis each dim is cut along), so a mesh run drops what the
    one-rank run drops."""
    if draws is None or rate <= 0.0:
        return h
    keep = 1.0 - rate
    divisor = float(torch.tensor(keep, dtype=h.dtype))
    mask = draws.ffn_keep(global_shape(h.shape, axes, spec), keep)
    if axes is not None:
        mask = axes.local(mask, spec)
    return torch.where(mask, h / divisor, torch.zeros_like(h))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)``: f32 statistics with the one-pass
    variance E[x²] − E[x]² (flax's ``use_fast_variance``), epsilon 1e-6."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + _LN_EPS) * ln.weight) + ln.bias


class MHA(nn.Module):
    """Multi-head attention; under a mesh (``axes``) the heads split over
    ``tp`` (q/k/v column-split, out row-split) and the route follows the
    reference: ``sp`` > 1 goes to ring or Ulysses attention
    (``METAOPT_TPU_SP_IMPL``), any other mesh of more than one rank to
    :func:`sharded_flash_attention`, one rank to :func:`flash_attention`."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0, axes=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
        self.axes = axes
        self.n_heads = local_sizes(axes, heads=(n_heads, "tp"))["heads"] if axes else n_heads
        self.d_head = d_model // n_heads
        self.dropout = dropout
        width = self.n_heads * self.d_head
        self.q = nn.Linear(d_model, width)
        self.k = nn.Linear(d_model, width)
        self.v = nn.Linear(d_model, width)
        self.out = nn.Linear(width, d_model)

    def forward(self, q_in, kv_in, mask=None, draws=None):
        """``draws`` given: training, attention dropout at ``self.dropout``.
        Under ``sp`` the inputs are this rank's sequence slices and ``mask``
        (b, 1, q|1, k) covers the whole sequences."""
        axes = self.axes
        b, sq, sk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        heads = lambda t, s: t.view(b, s, self.n_heads, self.d_head)  # noqa: E731
        q = heads(_dense_col(self.q, q_in, axes), sq) / math.sqrt(self.d_head)
        k = heads(_dense_col(self.k, kv_in, axes), sk)
        v = heads(_dense_col(self.v, kv_in, axes), sk)
        rate = self.dropout if draws is not None else 0.0
        # a copy: under remat the layer's draws are replayed, whole
        drop = dict(draws.attention_draw()) if rate > 0.0 else {}
        sp = axes.size("sp") if axes else 1
        # masks here are (b, 1, q|1, k) with heads shared — a broadcast view
        # of the kernel's (b, q, k) convention, read through its strides
        m3 = None
        if mask is not None:
            m3 = mask[:, 0].to(torch.int8).expand(b, sq * sp, sk * sp)
        if axes is None:
            out = flash_attention(q, k, v, m3, dropout_rate=rate, **drop)
        elif sp > 1:
            from metaopt_tpu_torch.ops.ulysses import sp_impl, ulysses_attention

            if sp_impl() == "ulysses":
                if "keep" in drop:
                    drop["keep"] = axes.local(drop["keep"], ("dp", "tp"))
                    drop["keep"] = axes.chunk(drop["keep"], 1, "sp")
                out = ulysses_attention(q, k, v, m3, mesh=axes.mesh, dropout_rate=rate, **drop)
            else:
                from metaopt_tpu_torch.ops.ring_attention import ring_attention

                if "keep" in drop:
                    drop["keep"] = axes.local(drop["keep"], ("dp", "tp", "sp"))
                out = ring_attention(q, k, v, None if m3 is None else axes.chunk(m3, 1, "sp"),
                                     mesh=axes.mesh, dropout_rate=rate, **drop)
        else:
            if "keep" in drop:
                drop["keep"] = axes.local(drop["keep"], ("dp", "tp"))
            out = sharded_flash_attention(axes.mesh, q, k, v, m3, dropout_rate=rate, **drop)
        return _dense_row(self.out, out.reshape(b, sq, -1), axes)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0, axes=None):
        super().__init__()
        self.axes = axes
        f = local_sizes(axes, d_ff=(d_ff, "tp"))["d_ff"] if axes else d_ff
        self.wi = nn.Linear(d_model, f)
        self.wo = nn.Linear(f, d_model)
        self.dropout = dropout

    def mask_shapes(self, b: int, s: int) -> List[tuple]:
        """The dropout masks one call on a (b, s, d) input draws, in order
        (whole masks: under a mesh each rank keeps its slice)."""
        if self.dropout <= 0.0:
            return []
        return [global_shape((b, s, self.wo.in_features), self.axes, ("dp", "sp", "tp"))]

    def forward(self, x, draws=None, aux=None):
        """``nn.Dropout`` after the relu when ``draws`` is given
        (:func:`ffn_dropout`). ``aux`` is the MoE's statistics sink, unused
        here."""
        h = torch.relu(_dense_col(self.wi, x, self.axes))
        return _dense_row(self.wo, ffn_dropout(h, self.dropout, draws, self.axes), self.axes)


def _make_mlp(d_model: int, d_ff: int, dropout: float, n_experts: int,
              capacity_factor: float, router_top_k: int, axes=None) -> nn.Module:
    if n_experts > 0:
        from metaopt_tpu_torch.models.moe import MoEFeedForward

        return MoEFeedForward(d_model, d_ff, n_experts, dropout, capacity_factor,
                              router_top_k, axes)
    return FeedForward(d_model, d_ff, dropout, axes)


class EncoderLayer(nn.Module):
    n_attention = 1  # attention calls per forward

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 n_experts: int = 0, capacity_factor: float = 1.25, router_top_k: int = 1,
                 axes=None):
        super().__init__()
        self.dropout = dropout
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads, dropout, axes)
        self.ln2 = nn.LayerNorm(d_model)
        self.mlp = _make_mlp(d_model, d_ff, dropout, n_experts, capacity_factor, router_top_k,
                             axes)

    def forward(self, x, pad_mask, draws=None, aux=None):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, pad_mask, draws)
        return x + self.mlp(_layer_norm(self.ln2, x), draws, aux)


class DecoderLayer(nn.Module):
    n_attention = 2

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 n_experts: int = 0, capacity_factor: float = 1.25, router_top_k: int = 1,
                 axes=None):
        super().__init__()
        self.dropout = dropout
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads, dropout, axes)
        self.ln2 = nn.LayerNorm(d_model)
        self.cross_attn = MHA(d_model, n_heads, dropout, axes)
        self.ln3 = nn.LayerNorm(d_model)
        self.mlp = _make_mlp(d_model, d_ff, dropout, n_experts, capacity_factor, router_top_k,
                             axes)

    def forward(self, x, enc, causal_mask, cross_mask, draws=None, aux=None):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, causal_mask, draws)
        y = _layer_norm(self.ln2, x)
        x = x + self.cross_attn(y, enc, cross_mask, draws)
        return x + self.mlp(_layer_norm(self.ln3, x), draws, aux)


# MoE statistics that carry no gradient (the dropped fraction)
_AUX_WITHOUT_GRAD = frozenset({"moe_stats"})


class _Remat(torch.autograd.Function):
    """One layer under remat (flax's ``nn.remat``): the forward runs the
    layer without a graph and saves only its inputs; the backward re-runs it
    with one on the replayed draws and takes the gradients of its inputs and
    parameters with ``torch.autograd.grad``. No RNG state is saved: the
    draws are already fixed (:class:`LayerDraws`). ``torch.utils.checkpoint``
    would do the same, but its first call imports ``torch._dynamo`` (~11 s
    in a fresh process on the card's host)."""

    @staticmethod
    def forward(ctx, run, n_args, x, *rest):
        args = rest[:n_args]
        ctx.run = run
        ctx.save_for_backward(x, *args)
        ctx.set_materialize_grads(False)
        outs = run(x, args, replay=False)
        ctx.mark_non_differentiable(*(t for key, t in zip(run.keys, outs[1:])
                                      if key in _AUX_WITHOUT_GRAD))
        return outs

    @staticmethod
    def backward(ctx, *grad_outs):
        x, *args = ctx.saved_tensors
        params = ctx.run.params
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(t.requires_grad) for t in (x, *args)]
            outs = ctx.run(inputs[0], tuple(inputs[1:]), replay=True)
        pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None and o.requires_grad]
        wrt = [t for t in inputs if t.requires_grad] + params
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True) if pairs else [None] * len(wrt))
        got = [next(grads) if t.requires_grad else None for t in inputs]
        # a parameter the recompute does not reach (an expert that received
        # no token) gets zeros, as jax.grad gives it
        got += [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return (None, None, *got)


class _LayerRun:
    """The callable :class:`_Remat` runs twice: ``layer(x, *args)`` on the
    layer's fixed draws (replayed on the second run), returning the output
    and the MoE statistics it appended to a local ``aux`` as a flat tuple."""

    def __init__(self, layer: nn.Module, fixed, with_aux: bool):
        self.layer, self.fixed, self.with_aux = layer, fixed, with_aux
        self.params = [p for p in layer.parameters() if p.requires_grad]
        self.keys: List[str] = []

    def __call__(self, x, args, replay: bool):
        local = {} if self.with_aux else None
        draws = None if self.fixed is None else self.fixed.replay()
        out = self.layer(x, *args, draws, local)
        flat = [(key, t) for key, ts in (local or {}).items() for t in ts]
        if not replay:
            self.keys = [key for key, _ in flat]
        return (out, *(t for _, t in flat))


def run_layer(layer: nn.Module, x: torch.Tensor, args: Tuple, draws, aux, remat: bool):
    """``layer(x, *args, ...)`` with its draws taken first (see
    :class:`LayerDraws`); under ``remat`` (and a graph being recorded)
    through :class:`_Remat`, which keeps only the layer's inputs and
    recomputes its forward in the backward. The MoE statistics the layer
    appends to ``aux`` leave it as outputs of its first run, so the balance
    loss's gradient flows back into the recompute."""
    fixed = None
    if draws is not None:
        fixed = LayerDraws.take(draws, layer.n_attention if layer.dropout > 0.0 else 0,
                                layer.mlp.mask_shapes(x.shape[0], x.shape[1]),
                                1.0 - layer.dropout)
    if not (remat and torch.is_grad_enabled()):
        return layer(x, *args, fixed, aux)
    run = _LayerRun(layer, fixed, aux is not None)
    outs = _Remat.apply(run, len(args), x, *args, *run.params)
    for key, t in zip(run.keys, outs[1:]):
        aux.setdefault(key, []).append(t)
    return outs[0]


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` (with ``embed`` and ``pos_embed``) in flax's
    distributions from ``generator``."""
    from metaopt_tpu_torch.models.moe import MoEFeedForward

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            init_dense_like_flax(mod, generator)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, MoEFeedForward):
            mod.init_tables_like_flax(generator)
    nn.init.normal_(model.embed.weight, 0.0, 1.0, generator=generator)
    nn.init.normal_(model.pos_embed, 0.0, 0.02, generator=generator)


class Transformer(nn.Module):
    """Encoder-decoder; Transformer-base defaults."""

    def __init__(self, vocab: int = 1000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, dropout: float = 0.1,
                 max_len: int = 512, n_experts: int = 0, capacity_factor: float = 1.25,
                 router_top_k: int = 1, remat: bool = False, mesh=None):
        super().__init__()
        self.vocab = vocab
        self.max_len = max_len
        self.remat = remat
        self.axes = axes = None if mesh is None else MeshAxes(mesh)
        moe = (n_experts, capacity_factor, router_top_k, axes)
        self.embed = nn.Embedding(vocab, d_model)
        # zeros until init_like_flax or a loaded state: never uninitialized memory
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.enc = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dropout, *moe) for _ in range(n_layers))
        self.enc_ln = nn.LayerNorm(d_model)
        self.dec = nn.ModuleList(
            DecoderLayer(d_model, n_heads, d_ff, dropout, *moe) for _ in range(n_layers))
        self.dec_ln = nn.LayerNorm(d_model)

    def init_like_flax(self, generator: torch.Generator) -> "Transformer":
        """Re-initialize in flax's distributions from ``generator``."""
        init_like_flax(self, generator)
        return self

    def forward(self, src, tgt_in, draws=None, *, features: bool = False, aux=None):
        """Logits (B, T, vocab) f32, or with ``features`` the pre-readout
        features (B, T, d) f32 for the blocked xent. ``draws`` given:
        training, with dropout drawn from it (the reference's ``train=True``);
        else deterministic. ``aux``, a dict, receives the MoE layers'
        ``aux_loss`` and ``moe_stats`` lists. Under a mesh ``src`` and
        ``tgt_in`` are this rank's ``dp`` rows, whole; the output is this
        rank's ``sp`` slice of the target positions."""
        s_len, t_len = src.shape[1], tgt_in.shape[1]
        if max(s_len, t_len) > self.max_len:
            raise ValueError(
                f"sequence length {max(s_len, t_len)} exceeds the positional "
                f"table (max_len={self.max_len}); pass max_len>=seq to "
                f"make_model"
            )
        check_sp(self.axes, s_len, t_len)
        src_pad = (src != 0)[:, None, None, :]                   # (b,1,1,k)
        causal = torch.tril(torch.ones(t_len, t_len, dtype=torch.bool,
                                       device=src.device))[None, None]
        causal_mask = causal & (tgt_in != 0)[:, None, None, :]   # (b,1,q,k)

        emb = self.embed.weight.bfloat16()
        pos = self.pos_embed.bfloat16()
        x = seq_slice(self.axes, emb[src] + pos[None, :s_len])
        for layer in self.enc:
            x = run_layer(layer, x, (src_pad,), draws, aux, self.remat)
        enc = _layer_norm(self.enc_ln, x).bfloat16()

        y = seq_slice(self.axes, emb[tgt_in] + pos[None, :t_len])
        for layer in self.dec:
            y = run_layer(layer, y, (enc, causal_mask, src_pad), draws, aux, self.remat)
        y = _layer_norm(self.dec_ln, y)
        return y if features else tied_readout(y, self.embed.weight)


def check_sp(axes, *lengths: int) -> None:
    """Sequence lengths must split over ``sp``: never a silent fallback to
    attention replicated over the sp ranks."""
    sp = axes.size("sp") if axes else 1
    if sp > 1 and any(n % sp for n in lengths):
        raise ValueError(
            f"seq lengths ({', '.join(map(str, lengths))}) must be multiples of the sp "
            f"mesh axis ({sp}); pad the batch or drop sp from the trial mesh")


def seq_slice(axes, x: torch.Tensor) -> torch.Tensor:
    """This rank's ``sp`` slice of (b, S, ...) along S."""
    return x if axes is None else axes.chunk(x, 1, "sp")


def tied_readout(y: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The weight-tied readout ``einsum("btd,vd->btv", bf16(y), table)`` with
    the f32 table, which jnp promotes to an f32 product of the bf16-rounded
    features (in f32 on the card: the port leaves TF32 off)."""
    return y.bfloat16().float() @ table.t()


# ---------------------------------------------------------------------------


def model_kwargs(h: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``make_model``/``make_lm`` hyperparameters and defaults."""
    return dict(
        vocab=int(h.get("vocab", 1000)),
        d_model=int(h.get("d_model", 512)),
        n_heads=int(h.get("n_heads", 8)),
        n_layers=int(h.get("n_layers", 6)),
        d_ff=int(h.get("d_ff", 2048)),
        dropout=float(h.get("dropout", 0.1)),
        max_len=int(h.get("max_len", 512)),
        n_experts=int(h.get("n_experts", 0)),
        capacity_factor=float(h.get("capacity_factor", 1.25)),
        router_top_k=int(h.get("router_top_k", 1)),
        remat=bool(h.get("remat", False)),
    )


def make_model(hparams: Optional[Dict[str, Any]] = None, mesh=None,
               **overrides) -> Transformer:
    """The Transformer of ``hparams``; with ``mesh``, this rank's shard of it
    (load :func:`~metaopt_tpu_torch.parallel.sharding.shard_params` of the
    whole model's state)."""
    h = dict(hparams or {})
    h.update(overrides)
    return Transformer(**model_kwargs(h), mesh=mesh)


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's flax parameter tree (numpy leaves) → a state_dict, for
    the Transformer (``enc{i}``, ``dec{i}``) or the decoder-only LM
    (``h{i}``, ``ln_f``).

    flax kernels are (in, ..., out); torch ``Linear`` weights are (out, in).
    The per-head kernels (d, H, Dh) and (H, Dh, d) flatten over the heads.
    A MoE layer's router is a ``Linear``; its expert tables ``wi`` (E, d, f)
    and ``wo`` (E, f, d) keep flax's layout.
    """
    def arr(x):
        x = getattr(x, "value", x)  # a boxed (partitioned) leaf
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, p, in_axes=1):
        w = arr(p["kernel"])
        sd[prefix + ".weight"] = w.reshape(
            int(np.prod(w.shape[:in_axes])), -1).t().contiguous()
        sd[prefix + ".bias"] = arr(p["bias"]).reshape(-1)

    def ln(prefix, p):
        sd[prefix + ".weight"] = arr(p["scale"])
        sd[prefix + ".bias"] = arr(p["bias"])

    def mha(prefix, p):
        for name in ("q", "k", "v"):
            dense(f"{prefix}.{name}", p[name])
        dense(f"{prefix}.out", p["out"], in_axes=2)

    def mlp(prefix, p):
        if "router" in p:
            dense(f"{prefix}.router", p["router"])
            sd[f"{prefix}.wi"], sd[f"{prefix}.wo"] = arr(p["wi"]), arr(p["wo"])
        else:
            dense(f"{prefix}.wi", p["wi"])
            dense(f"{prefix}.wo", p["wo"])

    sd["embed.weight"] = arr(flax_params["embed"]["embedding"])
    sd["pos_embed"] = arr(flax_params["pos_embed"])
    for name in ("enc", "h"):  # encoder layers, or the LM's blocks
        i = 0
        while f"{name}{i}" in flax_params:
            p = flax_params[f"{name}{i}"]
            ln(f"{name}.{i}.ln1", p["ln1"])
            mha(f"{name}.{i}.self_attn", p["self_attn"])
            ln(f"{name}.{i}.ln2", p["ln2"])
            mlp(f"{name}.{i}.mlp", p["mlp"])
            i += 1
    i = 0
    while f"dec{i}" in flax_params:
        p = flax_params[f"dec{i}"]
        for n in ("ln1", "ln2", "ln3"):
            ln(f"dec.{i}.{n}", p[n])
        mha(f"dec.{i}.self_attn", p["self_attn"])
        mha(f"dec.{i}.cross_attn", p["cross_attn"])
        mlp(f"dec.{i}.mlp", p["mlp"])
        i += 1
    for name in ("enc_ln", "dec_ln", "ln_f"):
        if name in flax_params:
            ln(name, flax_params[name])
    return sd


#: materialized f32 (B, T, V) logits size from which the losses take the
#: blocked xent: the reference's threshold, so that the same shapes take the
#: same route in both packages
_BLOCKED_XENT_MIN_LOGITS_BYTES = 4 << 30


def blocked_xent_enabled(batch: int, seq: int, vocab: int,
                         shards: Optional[int] = None) -> bool:
    """True when the losses fold the readout into the blocked xent: the
    f32 logits per device, ``4 · batch · seq · vocab / shards`` bytes, reach
    ``4 << 30``. ``shards`` is the ways the (B, T) dims are split; with the
    default None it is read from the ambient mesh (``dp · sp``; tp does not
    split them), 1 outside any mesh, as the reference reads it."""
    if shards is None:
        from metaopt_tpu_torch.parallel.mesh import axis_size

        mesh = active_mesh()
        shards = axis_size(mesh, "dp") * axis_size(mesh, "sp")
    return 4 * batch * seq * vocab // max(shards, 1) >= _BLOCKED_XENT_MIN_LOGITS_BYTES


def readout_xent(out: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 vocab: int, blocked: bool) -> torch.Tensor:
    """Per-token xent against the tied embedding ``table``. ``out`` is the
    pre-readout features when ``blocked`` (the (B, T, V) logits never
    exist: bf16 features and a bf16 copy of the table go through
    :func:`blocked_softmax_xent`), else the f32 logits."""
    if blocked:
        feats = out.reshape(-1, out.shape[-1]).bfloat16()
        return blocked_softmax_xent(feats, table.bfloat16(), labels.reshape(-1),
                                    pick_block_v(vocab)).view_as(labels)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1),
                           reduction="none").view_as(labels)


def masked_mean_with_aux(loss: torch.Tensor, mask: torch.Tensor,
                         aux: Mapping[str, Sequence[torch.Tensor]],
                         moe_aux_weight: float, axes=None) -> torch.Tensor:
    """Masked token mean plus the MoE switch load-balancing terms.

    Under a mesh ``loss`` and ``mask`` are this rank's tokens and the result
    is this rank's share: its masked sum over the mask count of every rank
    holding other tokens (``dp`` × ``sp``), plus its share of the balance
    terms (each already a global value). The shares sum to the one-rank
    loss, and the gradients summed over those ranks to its gradient."""
    group = axes.data if axes is not None else None
    count = mask.sum()
    if group is not None:
        count = coll.all_reduce_(count.detach().clone(), group)
    total = (loss * mask).sum() / count.clamp_min(1.0)
    terms = aux.get("aux_loss", [])
    if terms:
        n = axes.size("dp") * axes.size("sp") if axes is not None else 1
        total = total + moe_aux_weight * sum(t.sum() for t in terms) / n
    return total


def loss_fn(model: Transformer, batch, draws=None, moe_aux_weight: float = 0.01,
            stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Masked token-mean cross-entropy; ``tgt_in = [bos] ++ tgt[:, :-1]``,
    plus ``moe_aux_weight`` times the MoE balance losses. ``draws`` given:
    in training mode, dropout drawn from it. ``stats``, a dict, receives
    ``blocked_xent`` (the route taken) and the MoE layers' ``aux_loss`` and
    ``moe_stats`` lists. For a model on a mesh, ``batch`` is this rank's
    ``dp`` rows and the loss this rank's share (:func:`masked_mean_with_aux`)."""
    src, tgt = batch
    axes = model.axes
    bos = torch.ones_like(tgt[:, :1])
    tgt_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    dp = axes.size("dp") if axes else 1
    blocked = blocked_xent_enabled(tgt.shape[0] * dp, tgt.shape[1], model.vocab,
                                   dp * axes.size("sp") if axes else None)
    aux: Dict[str, List[torch.Tensor]] = {}
    out = model(src, tgt_in, draws, features=blocked, aux=aux)
    if stats is not None:
        stats.update(aux, blocked_xent=blocked)
    tgt = seq_slice(axes, tgt)
    loss = readout_xent(out, model.embed.weight, tgt, model.vocab, blocked)
    return masked_mean_with_aux(loss, (tgt != 0).float(), aux, moe_aux_weight, axes)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's schedule of the same name: linear warmup, then cosine decay."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


# optax.adamw's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class ScheduledAdamW:
    """``optax.adamw(schedule, weight_decay=...)`` in ``torch._foreach`` ops.

    The k-th update (from 0) uses ``schedule(k)``, as optax's
    ``scale_by_learning_rate`` does, so a warmup from 0 makes the first
    update a no-op on the parameters while the moments still absorb its
    gradient. ``torch.optim``'s first optimizer imports ``torch._dynamo``
    (~11 s in a fresh trial process); this class imports nothing.
    """

    def __init__(self, params, schedule, weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.updates = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        lr = self.schedule(self.updates)
        self.updates += 1
        grads = [p.grad for p in self.params]
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - _B2)
        # optax: mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, times -lr
        denom = torch._foreach_div(self.nu, 1.0 - _B2 ** self.updates)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(self.mu, 1.0 - _B1 ** self.updates)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_leaves(self) -> List[torch.Tensor]:
        """The optimizer state as a flat list: the update count, then the
        first and the second moments in parameter order."""
        return [torch.tensor(self.updates, dtype=torch.int64), *self.mu, *self.nu]

    @torch.no_grad()
    def load_state_leaves(self, leaves: Sequence[torch.Tensor]) -> None:
        n = len(self.params)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters")
        self.updates = int(leaves[0])
        for dst, src in zip(self.mu + self.nu, leaves[1:]):
            dst.copy_(src)


def trial_setup(hparams: Dict[str, Any], params, steps: int,
                tp: int = 1, sp: int = 1, ep: int = 1) -> ScheduledAdamW:
    """The trial-harness optimizer: AdamW over the reference's schedule.
    The mesh of ``tp``/``sp``/``ep`` is :func:`trial_axes`'s; the training
    entry points build it inside the trial's ranks."""
    if min(tp, sp, ep) < 1:
        raise ValueError(f"tp, sp, ep must be >= 1, got {tp}, {sp}, {ep}")
    lr = float(hparams.get("lr", 1e-3))
    warmup = int(hparams.get("warmup", 10))
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    return ScheduledAdamW(params, sched,
                          weight_decay=float(hparams.get("weight_decay", 0.0)))


def trial_axes(n_devices: int, tp: int = 1, sp: int = 1, ep: int = 1):
    """The trial mesh's axes over ``n_devices`` ranks: ``dp`` fills what tp,
    sp and ep leave (the reference's ``trial_mesh(tp, extra_axes)``), with
    its errors where they do not divide."""
    extra = [(name, n) for name, n in (("sp", sp), ("ep", ep)) if n > 1]
    return mesh_sizes([("dp", -1), ("tp", tp), *extra], n_devices)


def make_train_step(model: Transformer, opt: ScheduledAdamW, loss=None):
    """One optimizer update on a batch, dropout drawn from ``draws`` (none
    without); returns the pre-update loss. On a mesh each rank backpropagates
    its share of the loss; the gradients are summed over the ranks that hold
    other tokens (``dp`` × ``sp``) before the update, and the returned loss
    is the sum of the shares. ``loss`` is the loss function (:func:`loss_fn`
    unless given)."""
    group = model.axes.data if getattr(model, "axes", None) is not None else None
    fn = loss_fn if loss is None else loss

    def train_step(batch, draws=None) -> torch.Tensor:
        opt.zero_grad()
        value = fn(model, batch, draws)
        value.backward()
        sync_grads(opt.params, group)
        opt.step()
        return coll.all_reduce_(value.detach().clone(), group)

    return train_step


def sync_grads(params, group) -> None:
    """Sum the gradients over ``group`` in one flat all-reduce."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = coll.all_reduce_(torch.cat([g.reshape(-1).float() for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def ckpt_file(restore_or_save_dir: str) -> str:
    """The trial checkpoint's file: ``<dir>/state``, or on a mesh each
    rank's own slice, ``<dir>/state.rank<r>`` (restored on the same mesh)."""
    name = CKPT_FILE if not launch.in_rank() else f"{CKPT_FILE}.rank{launch.rank()}"
    return os.path.join(restore_or_save_dir, name)


def maybe_restore(restore_dir: Optional[str], model: Transformer,
                  opt: ScheduledAdamW) -> bool:
    """Load a trial checkpoint's parameters and optimizer state when
    ``restore_dir`` holds a published one (:func:`ckpt_file`, trees ``params``
    and ``opt_state``); returns whether it did. How a PBT continuation inherits its parent's
    training state and a re-run trial resumes its own."""
    if not restore_dir or not has_state(ckpt_file(restore_dir)):
        return False
    params = list(model.parameters())
    trees = restore_state(ckpt_file(restore_dir),
                          {"params": params, "opt_state": opt.state_leaves()})
    with torch.no_grad():
        for dst, src in zip(params, trees["params"]):
            dst.copy_(src)
    opt.load_state_leaves(trees["opt_state"])
    return True


def mesh_model(make, hparams: Dict[str, Any], mesh, device, seed: int):
    """The model of ``make(hparams)`` initialized like flax from ``seed`` on
    ``device``; with ``mesh``, this rank's shard of that same model (every
    rank initializes the whole model and keeps its slice, so a mesh trial
    starts from the one-rank trial's weights)."""
    with device:
        model = make(hparams)
    model.init_like_flax(torch.Generator(device=device).manual_seed(seed))
    if mesh is None:
        return model
    with device:
        local = make(hparams, mesh=mesh)
    local.load_state_dict(shard_params(mesh, model.state_dict()), strict=True)
    return local


def launch_trial(fn, hparams: Dict[str, Any], kw: Dict[str, Any], tp: int, sp: int, ep: int,
                 device, report: Optional[Dict[str, Any]]) -> Optional[float]:
    """Run a training entry point on the trial's ranks when its mesh has
    more than one: one rank per :func:`trial_devices` device, the mesh
    :func:`trial_axes`; rank 0's loss (and report). None when the trial
    runs on one rank (or already runs inside ranks)."""
    if launch.in_rank():
        return None
    devices = trial_devices(device)
    axes = trial_axes(len(devices), tp, sp, ep)
    if len(devices) == 1:
        return None
    out = launch.launch(_trial_rank, fn, hparams, kw, axes, devices=devices,
                        timeout_s=3600.0)
    if report is not None:
        report.update(out["report"])
    return out["loss"]


def _trial_rank(fn, hparams, kw, axes):
    """One rank of a launched trial: the mesh over the ranks, then ``fn``."""
    mesh = make_mesh(axes)
    report: Dict[str, Any] = {}
    loss = fn(hparams, mesh=mesh, device=launch.rank_device(), report=report, **kw)
    return {"loss": loss, "report": report}


def train_and_eval(
    hparams: Dict[str, Any],
    *,
    mesh=None,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    n_train: int = 2048,
    batch_size: int = 32,
    seq_len: int = 64,
    steps: int = 100,
    seed: int = 0,
    restore_dir: Optional[str] = None,
    save_dir: Optional[str] = None,
    device=None,
    report: Optional[Dict[str, Any]] = None,
) -> float:
    """Train on the synthetic translation task; return the final loss.

    Step i's dropout comes from ``Draws(seed, i)``; a restored trial starts
    its step count at 0 again, as the reference's does, while the
    optimizer's update count (the schedule's position) is restored.
    ``restore_dir``/``save_dir``: trial checkpoints (``<dir>/state``, the
    trees ``params`` and ``opt_state`` published together), skipped where
    ``restore_dir`` holds none. ``report``, when given, receives ``losses``
    (one per step), ``setup_s`` (model, optimizer, restore and data before
    the loop), ``train_s`` (the step loop, device-synchronized),
    ``save_s``, ``restored``, ``restored_updates`` and ``updates`` (the
    optimizer's update count after the restore and at the end), ``steps``,
    ``tokens_per_step`` (source + target tokens) and ``mesh`` (the axes the
    trial ran on, {} for one rank).

    With more than one trial device (:func:`trial_devices`) the trial runs
    one rank per device on the mesh of ``tp``, ``sp`` and ``ep`` (``dp``
    fills the rest) and returns rank 0's loss; inside ranks, ``mesh`` is the
    mesh and ``device`` the rank's device. A mesh trial draws the one-rank
    trial's dropout masks and keeps its slices (attention dropout excepted:
    its Philox seed is made distinct per mesh coordinate).
    """
    kw = dict(n_train=n_train, batch_size=batch_size, seq_len=seq_len, steps=steps,
              seed=seed, restore_dir=restore_dir, save_dir=save_dir)
    if mesh is None:
        loss = launch_trial(train_and_eval, hparams, dict(kw, tp=tp, sp=sp, ep=ep), tp, sp, ep,
                            device, report)
        if loss is not None:
            return loss
    t_call = time.perf_counter()
    if n_train < batch_size:
        raise ValueError(
            f"n_train ({n_train}) must be >= batch_size ({batch_size})")
    device = resolve_device(device)
    # built and initialized on the device it trains on: on the CPU, the init
    # of Transformer-base's 45 M parameters takes seconds per trial
    model = mesh_model(make_model, hparams, mesh, device, seed)
    opt = trial_setup(hparams, model.parameters(), steps, tp, sp, ep)
    restored = maybe_restore(restore_dir, model, opt)
    restored_updates = opt.updates
    src, tgt = synthetic_seq2seq(n_train, seq_len, model.vocab, seed=seed,
                                 device=device)
    step_fn = make_train_step(model, opt)
    axes = model.axes

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    with use_mesh(mesh):
        for i in range(steps):
            lo = (i * batch_size) % (n_train - batch_size + 1)
            batch = (src[lo:lo + batch_size], tgt[lo:lo + batch_size])
            if axes is not None:
                batch = shard_batch(axes, batch)
            losses.append(step_fn(batch, Draws(seed, i, device)))
    sync()
    train_s = time.perf_counter() - t0
    t_save = time.perf_counter()
    if save_dir:
        save_state(ckpt_file(save_dir),
                   {"params": list(model.parameters()), "opt_state": opt.state_leaves()})
    if report is not None:
        report.update(
            losses=[float(x) for x in losses],
            setup_s=t0 - t_call,
            train_s=train_s,
            save_s=time.perf_counter() - t_save,
            restored=restored,
            restored_updates=restored_updates,
            updates=opt.updates,
            steps=steps,
            tokens_per_step=2 * batch_size * seq_len,
            mesh=mesh_shape(mesh),
        )
    return float(losses[-1])


def make_objective(**fixed):
    def objective(params: Dict[str, Any]) -> float:
        kw = dict(fixed)
        if "epochs" in params:  # fidelity axis maps to train steps
            kw["steps"] = int(params["epochs"]) * kw.get("steps_per_epoch", 50)
            kw.pop("steps_per_epoch", None)
        return train_and_eval(params, **kw)

    return objective
