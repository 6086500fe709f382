"""Blocked softmax cross-entropy against a (tied) readout table.

Port of ``metaopt_tpu/ops/xent.py``. The loss of a big-vocabulary model
would otherwise materialize an f32 ``(N, V)`` logits tensor (4 GiB at N
32,768 tokens × V 32,768) and make several more full passes over it. This
op never builds it: the forward is a loop over vocab blocks, each block's
logits tile ``y @ emb[block]ᵀ`` feeding an online logsumexp while the label
logit is gathered block by block; it saves only ``lse``. The backward
recomputes each block's softmax from ``lse`` and accumulates dY and dEmb,
so live memory is O(N · block_v).

Each block product is a plain matrix product, which the reference also
computes outside any Pallas kernel, so it is ``torch.matmul`` here. The
reference multiplies bf16 operands with ``preferred_element_type=f32``
(f32 accumulation, f32 result); a bf16 ``torch.matmul`` would round its
result to bf16, so the port upcasts both operands to f32 first. A product
of two bf16 values is exact in f32, so this is the reference's product.
TF32: the port never enables it (PyTorch's default keeps
``torch.backends.cuda.matmul.allow_tf32`` off). Were it on, the result
would barely move: bf16 operands are exact in TF32, so only the order of
the f32 accumulation could differ.

FLOP cost: 2·N·D·V forward, 6·N·D·V backward (a logits recompute, dY and
dEmb), against 2 + 4 for the materializing path.
"""

from __future__ import annotations

import torch

def pick_block_v(vocab: int, target: int = 4096) -> int:
    """Largest divisor of ``vocab`` ≤ target (the loop's tile width).

    Falls back to the whole vocab when no useful divisor exists (e.g. a
    prime vocab): one big block degrades to the materializing path for that
    call, which is correct, just not leaner.
    """
    best = vocab
    for cand in range(min(target, vocab), 0, -1):
        if vocab % cand == 0:
            best = cand
            break
    # a block much narrower than asked (worst case 1, for a prime vocab)
    # would make the loop absurdly long: degrade to one whole-vocab block
    return best if best >= max(1, target // 8) else vocab


def _label_slots(labels: torch.Tensor, i: int, block_v: int):
    """(inside, loc): whether each label falls in block i, and its column."""
    loc = labels - i * block_v
    return (loc >= 0) & (loc < block_v), loc.clamp(0, block_v - 1)


class _BlockedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, emb, labels, block_v):
        v = emb.shape[0]
        if v % block_v:
            raise ValueError(f"block_v {block_v} must divide the vocab {v}")
        y32 = y.float()
        n = y.shape[0]
        m = torch.full((n,), -float("inf"), device=y.device)
        l = torch.zeros((n,), device=y.device)
        lab = torch.zeros((n,), device=y.device)
        for i in range(v // block_v):
            s = y32 @ emb[i * block_v:(i + 1) * block_v].float().t()     # (N, bv)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
            inside, loc = _label_slots(labels, i, block_v)
            lab = torch.where(inside, s.gather(1, loc[:, None])[:, 0], lab)
            m = m_new
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(y, emb, labels, lse)
        ctx.block_v = block_v
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        """d loss / d logits = softmax(logits) − onehot(label), times g."""
        y, emb, labels, lse = ctx.saved_tensors
        block_v = ctx.block_v
        y32, gf = y.float(), g.float()
        dy = torch.zeros_like(y32)
        demb = torch.empty(emb.shape, dtype=torch.float32, device=emb.device)
        for i in range(emb.shape[0] // block_v):
            rows = slice(i * block_v, (i + 1) * block_v)
            eb = emb[rows].float()
            p = torch.exp(y32 @ eb.t() - lse[:, None])                   # softmax tile
            inside, loc = _label_slots(labels, i, block_v)
            # p − onehot: subtract 1 at each label inside this block (adding
            # −0.0 elsewhere leaves p as it is)
            p.scatter_add_(1, loc[:, None], -inside.float()[:, None])
            ds = p * gf[:, None]
            dy += ds @ eb
            demb[rows] = ds.t() @ y32
        return dy.to(y.dtype), demb.to(emb.dtype), None, None


def blocked_softmax_xent(y: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                         block_v: int = 2048) -> torch.Tensor:
    """Per-token ``lse(y·embᵀ) − (y·embᵀ)[label]`` without (N, V) logits.

    y: (N, D) features (bf16 recommended); emb: (V, D) readout table;
    labels: (N,) integers in [0, V). ``block_v`` must divide V (use
    :func:`pick_block_v`: padding the table would add spurious mass to
    every denominator). Returns (N,) f32 losses, differentiable in y and
    emb.
    """
    return _BlockedXent.apply(y, emb, labels, block_v)
