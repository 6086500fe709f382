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

:func:`params_from_flax` converts the reference's parameter tree so both
packages compute the same function in the tests. Not ported yet (queued in
ROADMAP.md): attention dropout (the kernels carry none; ``dropout > 0``
raises), the dp/tp/sp/ep meshes, MoE FFNs, ``remat``, the blocked xent and
orbax checkpoints.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.data import synthetic_seq2seq
from metaopt_tpu_torch.ops.attention import flash_attention
from metaopt_tpu_torch.utils.device import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm default
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


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)``: f32 statistics with the one-pass
    variance E[x²] − E[x]² (flax's ``use_fast_variance``), epsilon 1e-6."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + _LN_EPS) * ln.weight) + ln.bias


class MHA(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q_in, kv_in, mask=None):
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
        out = flash_attention(q, k, v, m3)
        return _dense(self.out, out.reshape(b, sq, -1))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi = nn.Linear(d_model, d_ff)
        self.wo = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return _dense(self.wo, torch.relu(_dense(self.wi, x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads)
        self.ln2 = nn.LayerNorm(d_model)
        self.mlp = FeedForward(d_model, d_ff)

    def forward(self, x, pad_mask):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, pad_mask)
        return x + self.mlp(_layer_norm(self.ln2, x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model)
        self.self_attn = MHA(d_model, n_heads)
        self.ln2 = nn.LayerNorm(d_model)
        self.cross_attn = MHA(d_model, n_heads)
        self.ln3 = nn.LayerNorm(d_model)
        self.mlp = FeedForward(d_model, d_ff)

    def forward(self, x, enc, causal_mask, cross_mask):
        y = _layer_norm(self.ln1, x)
        x = x + self.self_attn(y, y, causal_mask)
        y = _layer_norm(self.ln2, x)
        x = x + self.cross_attn(y, enc, cross_mask)
        return x + self.mlp(_layer_norm(self.ln3, x))


class Transformer(nn.Module):
    """Encoder-decoder; Transformer-base defaults."""

    def __init__(self, vocab: int = 1000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, max_len: int = 512):
        super().__init__()
        self.vocab = vocab
        self.max_len = max_len
        self.embed = nn.Embedding(vocab, d_model)
        # zeros until init_like_flax or a loaded state: never uninitialized memory
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.enc = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff) for _ in range(n_layers))
        self.enc_ln = nn.LayerNorm(d_model)
        self.dec = nn.ModuleList(
            DecoderLayer(d_model, n_heads, d_ff) for _ in range(n_layers))
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

    def forward(self, src, tgt_in):
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
            x = layer(x, src_pad)
        enc = _layer_norm(self.enc_ln, x).bfloat16()

        y = emb[tgt_in] + pos[None, :t_len]
        for layer in self.dec:
            y = layer(y, enc, causal_mask, src_pad)
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
    if float(h.get("dropout", 0.1)) > 0.0:
        raise NotImplementedError(
            "dropout > 0 is not ported yet: the flash kernels carry no "
            "attention dropout (pass dropout=0.0)")
    return Transformer(
        vocab=int(h.get("vocab", 1000)),
        d_model=int(h.get("d_model", 512)),
        n_heads=int(h.get("n_heads", 8)),
        n_layers=int(h.get("n_layers", 6)),
        d_ff=int(h.get("d_ff", 2048)),
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


def loss_fn(model: Transformer, batch) -> torch.Tensor:
    """Masked token-mean cross-entropy; ``tgt_in = [bos] ++ tgt[:, :-1]``."""
    src, tgt = batch
    bos = torch.ones_like(tgt[:, :1])
    tgt_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    logits = model(src, tgt_in)
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


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose learning rate follows ``schedule(updates so far)``.

    Like ``optax.adamw(schedule)``, the k-th update (from 0) uses
    ``schedule(k)``, so a warmup from 0 makes the first update a no-op on
    the parameters while the moments still absorb its gradient.
    """

    def __init__(self, params, schedule, weight_decay: float = 0.0):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.schedule = schedule
        self.updates = 0

    def step(self, closure=None):
        lr = self.schedule(self.updates)
        for group in self.param_groups:
            group["lr"] = lr
        out = super().step(closure)
        self.updates += 1
        return out


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


def make_train_step(model: Transformer, opt: torch.optim.Optimizer):
    """One optimizer update on a batch; returns the pre-update loss."""

    def train_step(batch) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


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
    device=None,
    report: Optional[Dict[str, Any]] = None,
) -> float:
    """Train on the synthetic translation task; return the final loss.

    ``report``, when given, receives ``losses`` (one per step), ``train_s``
    (seconds of the step loop, device-synchronized), ``steps`` and
    ``tokens_per_step`` (source + target tokens).
    """
    if n_train < batch_size:
        raise ValueError(
            f"n_train ({n_train}) must be >= batch_size ({batch_size})")
    device = resolve_device(device)
    model = make_model(hparams)
    model.init_like_flax(torch.Generator().manual_seed(seed))
    model.to(device)
    opt = trial_setup(hparams, model.parameters(), steps, tp, sp, ep)
    src, tgt = synthetic_seq2seq(n_train, seq_len, model.vocab, seed=seed,
                                 device=device)
    step_fn = make_train_step(model, opt)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        lo = (i * batch_size) % (n_train - batch_size + 1)
        losses.append(step_fn((src[lo:lo + batch_size], tgt[lo:lo + batch_size])))
    sync()
    if report is not None:
        report.update(
            losses=[float(x) for x in losses],
            train_s=time.perf_counter() - t0,
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
