"""Transformer-base seq2seq — the demo trial workload, on PyTorch.

Port of ``metaopt_tpu/models/transformer.py`` for one device: an
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
- the optimizer is ``optax.adamw`` over the reference's schedule, written
  in ``torch._foreach`` ops (:class:`ScheduledAdamW`): ``torch.optim``'s
  first optimizer imports ``torch._dynamo``, ~11 s per trial process.

:func:`params_from_flax` converts the reference's parameter tree so both
packages compute the same function in the tests. Trial checkpoints
(``train_and_eval(restore_dir=..., save_dir=...)``) are the port's own
format (:mod:`metaopt_tpu_torch.models.checkpoint`), not orbax. Not ported
yet (queued in ROADMAP.md): the dp/tp/sp/ep meshes, MoE FFNs, ``remat``
and the blocked xent.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.checkpoint import has_state, restore_state, save_state
from metaopt_tpu_torch.models.data import synthetic_seq2seq
from metaopt_tpu_torch.ops.attention import flash_attention
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

    def ffn_keep(self, shape, keep: float) -> torch.Tensor:
        return torch.rand(shape, generator=self._ffn, device=self.device) < keep


class GivenDraws:
    """Draws fixed in advance: ``ffn_masks``, one keep mask per feed-forward
    layer in the order they run (encoder layers, then decoder layers), and
    the attention seeds from a CPU generator seeded with ``attention_seed``."""

    def __init__(self, ffn_masks: Sequence[Any], attention_seed: int, device):
        dev = torch.device(device)
        self._masks = [torch.as_tensor(np.asarray(m), dtype=torch.bool).to(dev)
                       for m in ffn_masks]
        self._next = 0
        self.attention = torch.Generator().manual_seed(int(attention_seed))

    def ffn_keep(self, shape, keep: float) -> torch.Tensor:
        mask = self._masks[self._next]
        self._next += 1
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"given mask of shape {tuple(mask.shape)}, the layer needs "
                             f"{tuple(shape)}")
        return mask


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)``: f32 statistics with the one-pass
    variance E[x²] − E[x]² (flax's ``use_fast_variance``), epsilon 1e-6."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + _LN_EPS) * ln.weight) + ln.bias


class MHA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.dropout = dropout
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, kv_in, mask=None, draws=None):
        """``draws`` given: training, attention dropout at ``self.dropout``."""
        b, sq, sk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
        heads = lambda t, s: t.view(b, s, self.n_heads, self.d_head)  # noqa: E731
        q = heads(_dense(self.q, q_in), sq) / math.sqrt(self.d_head)
        k = heads(_dense(self.k, kv_in), sk)
        v = heads(_dense(self.v, kv_in), sk)
        # masks here are (b, 1, q|1, k) with heads shared — a broadcast view
        # of the kernel's (b, q, k) convention, read through its strides
        m3 = None
        if mask is not None:
            m3 = mask[:, 0].to(torch.int8).expand(b, sq, sk)
        rate = self.dropout if draws is not None else 0.0
        out = flash_attention(q, k, v, m3, dropout_rate=rate,
                              generator=draws.attention if rate > 0.0 else None)
        return _dense(self.out, out.reshape(b, sq, -1))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.wi = nn.Linear(d_model, d_ff)
        self.wo = nn.Linear(d_ff, d_model)
        self.dropout = dropout

    def forward(self, x, draws=None):
        """flax ``nn.Dropout`` after the relu when ``draws`` is given: kept
        activations over keep_prob, the rest 0. flax divides the bf16
        activations by its weak-typed keep_prob, which takes their dtype
        first: keep_prob is rounded to bf16 before the division."""
        h = torch.relu(_dense(self.wi, x))
        if draws is not None and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            divisor = float(torch.tensor(keep, dtype=h.dtype))
            h = torch.where(draws.ffn_keep(h.shape, keep), h / divisor, torch.zeros_like(h))
        return _dense(self.wo, h)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads, dropout)
        self.ln2 = nn.LayerNorm(d_model)
        self.mlp = FeedForward(d_model, d_ff, dropout)

    def forward(self, x, pad_mask, draws=None):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, pad_mask, draws)
        return x + self.mlp(_layer_norm(self.ln2, x), draws)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads, dropout)
        self.ln2 = nn.LayerNorm(d_model)
        self.cross_attn = MHA(d_model, n_heads, dropout)
        self.ln3 = nn.LayerNorm(d_model)
        self.mlp = FeedForward(d_model, d_ff, dropout)

    def forward(self, x, enc, causal_mask, cross_mask, draws=None):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, causal_mask, draws)
        y = _layer_norm(self.ln2, x)
        x = x + self.cross_attn(y, enc, cross_mask, draws)
        return x + self.mlp(_layer_norm(self.ln3, x), draws)


class Transformer(nn.Module):
    """Encoder-decoder; Transformer-base defaults."""

    def __init__(self, vocab: int = 1000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, dropout: float = 0.1,
                 max_len: int = 512):
        super().__init__()
        self.vocab = vocab
        self.max_len = max_len
        self.embed = nn.Embedding(vocab, d_model)
        # zeros until init_like_flax or a loaded state: never uninitialized memory
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.enc = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dropout) for _ in range(n_layers))
        self.enc_ln = nn.LayerNorm(d_model)
        self.dec = nn.ModuleList(
            DecoderLayer(d_model, n_heads, d_ff, dropout) for _ in range(n_layers))
        self.dec_ln = nn.LayerNorm(d_model)

    @torch.no_grad()
    def init_like_flax(self, generator: torch.Generator) -> "Transformer":
        """Re-initialize in flax's distributions from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_dense_like_flax(mod, generator)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        nn.init.normal_(self.embed.weight, 0.0, 1.0, generator=generator)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        return self

    def forward(self, src, tgt_in, draws=None):
        """Logits (B, T, vocab) f32. ``draws`` given: training, with dropout
        drawn from it (the reference's ``train=True``); else deterministic."""
        s_len, t_len = src.shape[1], tgt_in.shape[1]
        if max(s_len, t_len) > self.max_len:
            raise ValueError(
                f"sequence length {max(s_len, t_len)} exceeds the positional "
                f"table (max_len={self.max_len}); pass max_len>=seq to "
                f"make_model"
            )
        src_pad = (src != 0)[:, None, None, :]                   # (b,1,1,k)
        causal = torch.tril(torch.ones(t_len, t_len, dtype=torch.bool,
                                       device=src.device))[None, None]
        causal_mask = causal & (tgt_in != 0)[:, None, None, :]   # (b,1,q,k)

        emb = self.embed.weight.bfloat16()
        pos = self.pos_embed.bfloat16()
        x = emb[src] + pos[None, :s_len]
        for layer in self.enc:
            x = layer(x, src_pad, draws)
        enc = _layer_norm(self.enc_ln, x).bfloat16()

        y = emb[tgt_in] + pos[None, :t_len]
        for layer in self.dec:
            y = layer(y, enc, causal_mask, src_pad, draws)
        y = _layer_norm(self.dec_ln, y)
        # weight-tied readout: bf16 features against the f32 table, in f32
        return y.bfloat16().float() @ self.embed.weight.t()


# ---------------------------------------------------------------------------


def make_model(hparams: Optional[Dict[str, Any]] = None, **overrides) -> Transformer:
    h = dict(hparams or {})
    h.update(overrides)
    if int(h.get("n_experts", 0)) > 0:
        raise NotImplementedError("MoE feed-forward layers are not ported yet")
    if bool(h.get("remat", False)):
        raise NotImplementedError("remat is not ported yet")
    return Transformer(
        vocab=int(h.get("vocab", 1000)),
        d_model=int(h.get("d_model", 512)),
        n_heads=int(h.get("n_heads", 8)),
        n_layers=int(h.get("n_layers", 6)),
        d_ff=int(h.get("d_ff", 2048)),
        dropout=float(h.get("dropout", 0.1)),
        max_len=int(h.get("max_len", 512)),
    )


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's flax parameter tree (numpy leaves) → a state_dict.

    flax kernels are (in, ..., out); torch ``Linear`` weights are (out, in).
    The per-head kernels (d, H, Dh) and (H, Dh, d) flatten over the heads.
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

    sd["embed.weight"] = arr(flax_params["embed"]["embedding"])
    sd["pos_embed"] = arr(flax_params["pos_embed"])
    i = 0
    while f"enc{i}" in flax_params:
        p = flax_params[f"enc{i}"]
        ln(f"enc.{i}.ln1", p["ln1"])
        mha(f"enc.{i}.self_attn", p["self_attn"])
        ln(f"enc.{i}.ln2", p["ln2"])
        dense(f"enc.{i}.mlp.wi", p["mlp"]["wi"])
        dense(f"enc.{i}.mlp.wo", p["mlp"]["wo"])
        i += 1
    i = 0
    while f"dec{i}" in flax_params:
        p = flax_params[f"dec{i}"]
        for n in ("ln1", "ln2", "ln3"):
            ln(f"dec.{i}.{n}", p[n])
        mha(f"dec.{i}.self_attn", p["self_attn"])
        mha(f"dec.{i}.cross_attn", p["cross_attn"])
        dense(f"dec.{i}.mlp.wi", p["mlp"]["wi"])
        dense(f"dec.{i}.mlp.wo", p["mlp"]["wo"])
        i += 1
    ln("enc_ln", flax_params["enc_ln"])
    ln("dec_ln", flax_params["dec_ln"])
    return sd


def loss_fn(model: Transformer, batch, draws=None) -> torch.Tensor:
    """Masked token-mean cross-entropy; ``tgt_in = [bos] ++ tgt[:, :-1]``.
    ``draws`` given: in training mode, dropout drawn from it."""
    src, tgt = batch
    bos = torch.ones_like(tgt[:, :1])
    tgt_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    logits = model(src, tgt_in, draws)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1), reduction="none").view_as(tgt)
    mask = (tgt != 0).float()
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


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
    """The trial-harness optimizer: AdamW over the reference's schedule."""
    if tp > 1 or sp > 1 or ep > 1:
        raise NotImplementedError(
            "tp/sp/ep meshes are not ported yet: the one-device path runs "
            "with tp = sp = ep = 1")
    lr = float(hparams.get("lr", 1e-3))
    warmup = int(hparams.get("warmup", 10))
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    return ScheduledAdamW(params, sched,
                          weight_decay=float(hparams.get("weight_decay", 0.0)))


def make_train_step(model: Transformer, opt: ScheduledAdamW):
    """One optimizer update on a batch, dropout drawn from ``draws`` (none
    without); returns the pre-update loss."""

    def train_step(batch, draws=None) -> torch.Tensor:
        opt.zero_grad()
        loss = loss_fn(model, batch, draws)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def maybe_restore(restore_dir: Optional[str], model: Transformer,
                  opt: ScheduledAdamW) -> bool:
    """Load a trial checkpoint's parameters and optimizer state when
    ``restore_dir`` holds a published one (``CKPT_FILE``, trees ``params``
    and ``opt_state``); returns whether it did. How a PBT continuation inherits its parent's
    training state and a re-run trial resumes its own."""
    if not restore_dir or not has_state(os.path.join(restore_dir, CKPT_FILE)):
        return False
    params = list(model.parameters())
    trees = restore_state(os.path.join(restore_dir, CKPT_FILE),
                          {"params": params, "opt_state": opt.state_leaves()})
    with torch.no_grad():
        for dst, src in zip(params, trees["params"]):
            dst.copy_(src)
    opt.load_state_leaves(trees["opt_state"])
    return True


def train_and_eval(
    hparams: Dict[str, Any],
    *,
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
    optimizer's update count after the restore and at the end), ``steps``
    and ``tokens_per_step`` (source + target tokens).
    """
    t_call = time.perf_counter()
    if n_train < batch_size:
        raise ValueError(
            f"n_train ({n_train}) must be >= batch_size ({batch_size})")
    device = resolve_device(device)
    # built and initialized on the device it trains on: on the CPU, the init
    # of Transformer-base's 45 M parameters takes seconds per trial
    with device:
        model = make_model(hparams)
    model.init_like_flax(torch.Generator(device=device).manual_seed(seed))
    opt = trial_setup(hparams, model.parameters(), steps, tp, sp, ep)
    restored = maybe_restore(restore_dir, model, opt)
    restored_updates = opt.updates
    src, tgt = synthetic_seq2seq(n_train, seq_len, model.vocab, seed=seed,
                                 device=device)
    step_fn = make_train_step(model, opt)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        lo = (i * batch_size) % (n_train - batch_size + 1)
        losses.append(step_fn((src[lo:lo + batch_size], tgt[lo:lo + batch_size]),
                              Draws(seed, i, device)))
    sync()
    train_s = time.perf_counter() - t0
    t_save = time.perf_counter()
    if save_dir:
        save_state(os.path.join(save_dir, CKPT_FILE),
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
