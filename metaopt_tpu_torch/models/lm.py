"""Decoder-only causal language model (port of ``metaopt_tpu/models/lm.py``).

One causal trunk, tied readout, next-token loss. Like the reference it
reuses the seq2seq Transformer's pieces (:mod:`metaopt_tpu_torch.models.
transformer`):

- a bf16 embedding plus a bf16 positional table (``pos_embed``, initialized
  normal(0.02) as the Transformer's is);
- ``n_layers`` pre-LN ``EncoderLayer``\\ s under ``causal & pad``, so every
  attention call is the flash-attention kernels K1–K3 with that mask (K1
  skips the K tiles the causal mask hides from a whole Q tile); MoE FFNs
  with ``n_experts > 0``; ``remat`` per layer, its draws taken before each
  layer so the recompute replays them;
- ``ln_f``, then the tied readout against the f32 table;
- the loss routes through :func:`readout_xent`, so the same logits-bytes
  threshold picks the blocked xent at big vocab × long sequence.

``train_lm`` trains on the permutation-walk streams of
:func:`metaopt_tpu_torch.models.data.synthetic_lm` with the foreach AdamW,
on one device (tp, sp or ep above 1 raise, as for the Transformer), and
takes the Transformer's trial checkpoints (one file, published by rename).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from metaopt_tpu_torch.models.checkpoint import save_state
from metaopt_tpu_torch.models.data import synthetic_lm
from metaopt_tpu_torch.models.transformer import (
    CKPT_FILE,
    Draws,
    EncoderLayer,
    _layer_norm,
    blocked_xent_enabled,
    init_like_flax,
    masked_mean_with_aux,
    maybe_restore,
    model_kwargs,
    readout_xent,
    run_layer,
    tied_readout,
    trial_setup,
)
from metaopt_tpu_torch.utils.device import resolve_device


class DecoderOnlyLM(nn.Module):
    """Causal LM: embed + pos → n_layers pre-LN blocks → tied readout."""

    def __init__(self, vocab: int = 1000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048, dropout: float = 0.1,
                 max_len: int = 512, n_experts: int = 0, capacity_factor: float = 1.25,
                 router_top_k: int = 1, remat: bool = False):
        super().__init__()
        self.vocab = vocab
        self.max_len = max_len
        self.remat = remat
        self.embed = nn.Embedding(vocab, d_model)
        # zeros until init_like_flax or a loaded state: never uninitialized memory
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.h = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dropout, n_experts, capacity_factor,
                         router_top_k) for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model)

    def init_like_flax(self, generator: torch.Generator) -> "DecoderOnlyLM":
        """Re-initialize in flax's distributions from ``generator``."""
        init_like_flax(self, generator)
        return self

    def forward(self, tokens, draws=None, *, features: bool = False, aux=None):
        """Logits (B, T, vocab) f32, or with ``features`` the pre-readout
        features (B, T, d) f32 for the blocked xent. ``draws`` given:
        training, dropout drawn from it; ``aux``, a dict, receives the MoE
        layers' ``aux_loss`` and ``moe_stats`` lists."""
        t_len = tokens.shape[1]
        if t_len > self.max_len:
            raise ValueError(
                f"sequence length {t_len} exceeds the positional table "
                f"(max_len={self.max_len}); pass max_len>=seq to make_lm"
            )
        causal = torch.tril(torch.ones(t_len, t_len, dtype=torch.bool,
                                       device=tokens.device))[None, None]
        mask = causal & (tokens != 0)[:, None, None, :]                 # (b,1,q,k)
        x = self.embed.weight.bfloat16()[tokens] + self.pos_embed.bfloat16()[None, :t_len]
        for layer in self.h:
            x = run_layer(layer, x, (mask,), draws, aux, self.remat)
        x = _layer_norm(self.ln_f, x)
        return x if features else tied_readout(x, self.embed.weight)


def make_lm(hparams: Optional[Dict[str, Any]] = None, **overrides) -> DecoderOnlyLM:
    h = dict(hparams or {})
    h.update(overrides)
    return DecoderOnlyLM(**model_kwargs(h))


def lm_loss_fn(model: DecoderOnlyLM, tokens: torch.Tensor, draws=None,
               moe_aux_weight: float = 0.01,
               stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Next-token loss: predict ``tokens[:, 1:]`` from ``tokens[:, :-1]``,
    masked where the label is pad (0), plus ``moe_aux_weight`` times the
    MoE balance losses. ``stats``, a dict, receives ``blocked_xent`` (the
    route taken) and the MoE layers' ``aux_loss`` and ``moe_stats`` lists."""
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    blocked = blocked_xent_enabled(labels.shape[0], labels.shape[1], model.vocab)
    aux: Dict[str, List[torch.Tensor]] = {}
    out = model(inp, draws, features=blocked, aux=aux)
    if stats is not None:
        stats.update(aux, blocked_xent=blocked)
    loss = readout_xent(out, model.embed.weight, labels, model.vocab, blocked)
    return masked_mean_with_aux(loss, (labels != 0).float(), aux, moe_aux_weight)


def make_lm_train_step(model: DecoderOnlyLM, opt):
    """One optimizer update on a token batch, dropout drawn from ``draws``
    (none without); returns the pre-update loss."""

    def train_step(tokens: torch.Tensor, draws=None) -> torch.Tensor:
        opt.zero_grad()
        loss = lm_loss_fn(model, tokens, draws)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def train_lm(
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
    """Train on the permutation-walk LM task; return the final loss.

    ``seq_len`` is the length the model trains on: the streams hold
    ``seq_len + 1`` tokens, so the shift in :func:`lm_loss_fn` lands back on
    ``seq_len``. Step i's batch starts at ``(i · batch_size) % (n_train −
    batch_size + 1)`` and its dropout comes from ``Draws(seed, i)``.
    ``restore_dir``/``save_dir`` and ``report`` are
    :func:`~metaopt_tpu_torch.models.transformer.train_and_eval`'s
    (``tokens_per_step`` is ``batch_size · seq_len``).
    """
    t_call = time.perf_counter()
    if n_train < batch_size:
        raise ValueError(
            f"n_train ({n_train}) must be >= batch_size ({batch_size})")
    device = resolve_device(device)
    with device:
        model = make_lm(hparams, max_len=max(int(hparams.get("max_len", 512)), seq_len))
    model.init_like_flax(torch.Generator(device=device).manual_seed(seed))
    opt = trial_setup(hparams, model.parameters(), steps, tp, sp, ep)
    restored = maybe_restore(restore_dir, model, opt)
    restored_updates = opt.updates
    toks = synthetic_lm(n_train, seq_len + 1, model.vocab, seed=seed, device=device)
    step_fn = make_lm_train_step(model, opt)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        lo = (i * batch_size) % (n_train - batch_size + 1)
        losses.append(step_fn(toks[lo:lo + batch_size], Draws(seed, i, device)))
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
            tokens_per_step=batch_size * seq_len,
        )
    return float(losses[-1])
