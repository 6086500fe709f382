"""A transformer LM assembled as pipeline stages (port of
``metaopt_tpu/models/pipeline_lm.py``).

The stage trunk is the port's ``EncoderLayer`` — self-attention (the
flash-attention kernels K1–K3) and feed-forward with the same bf16/f32
mixed precision — stacked P·V deep with one parameter slice per logical
stage (each leaf a (P·V, ...) tensor). :func:`~metaopt_tpu_torch.parallel.
pipeline.pipeline_apply` runs them under the interleaved schedule with the
token embedding as ``pre_fn`` and the vocab readout as ``post_fn``.

The stage layer runs one rank's way (no tp mesh inside a pipeline stage),
called on each stage's slice with ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metaopt_tpu_torch.models.transformer import (EncoderLayer, init_dense_like_flax,
                                                   params_from_flax)
from metaopt_tpu_torch.parallel import collectives as coll
from metaopt_tpu_torch.parallel.mesh import axes_group, axis_size
from metaopt_tpu_torch.parallel.pipeline import pipeline_apply, tree_leaves, tree_map
from metaopt_tpu_torch.utils.device import resolve_device


def _layer(hparams: Mapping[str, Any]) -> EncoderLayer:
    return EncoderLayer(int(hparams.get("d_model", 32)), int(hparams.get("n_heads", 2)),
                        int(hparams.get("d_ff", 64)), dropout=0.0)


def make_pipeline_lm(hparams: Dict[str, Any], n_stages: int, virtual_stages: int = 2,
                     seq: int = 16, seed: int = 0, device=None) -> Tuple[Any, Any]:
    """``(fns, params)`` of a P·V-layer pipeline LM: ``fns = (stage_fn,
    pre_fn, post_fn)``, ``params = (stage_params, pre_params, post_params)``
    with ``stage_params`` leaves leading with the logical-stage dimension
    P·V. The layers are initialized as flax initializes them, the ends as
    the reference draws them (normal(1/sqrt(d)) table and readout,
    normal(0.02) positions), from ``seed``."""
    device = resolve_device(device)
    d = int(hparams.get("d_model", 32))
    vocab = int(hparams.get("vocab", 101))
    gen = torch.Generator().manual_seed(int(seed))
    layers = []
    for _ in range(n_stages * virtual_stages):
        layer = _layer(hparams)
        for mod in layer.modules():
            if isinstance(mod, torch.nn.Linear):
                init_dense_like_flax(mod, gen)
        layers.append(layer.state_dict())
    stage_params = {k: torch.stack([sd[k] for sd in layers]).to(device) for k in layers[0]}
    pre_params = {"emb": (torch.randn(vocab, d, generator=gen) / np.sqrt(d)).to(device),
                  "pos": (torch.randn(seq, d, generator=gen) * 0.02).to(device)}
    post_params = {"ro": (torch.randn(d, vocab, generator=gen) / np.sqrt(d)).to(device)}
    return stage_fns(hparams, device), (stage_params, pre_params, post_params)


def stage_fns(hparams: Mapping[str, Any], device=None):
    """(stage_fn, pre_fn, post_fn) of the pipeline LM of ``hparams``."""
    with torch.device(resolve_device(device)):
        layer = _layer(hparams)

    def stage_fn(p, h):   # mask None = full attention
        return torch.func.functional_call(layer, p, (h, None))

    def pre_fn(p, toks):  # (mb, S) int -> (mb, S, d)
        return p["emb"][toks] + p["pos"][None, : toks.shape[1]]

    def post_fn(p, h):    # (mb, S, d) -> (mb, S, vocab)
        return h.float() @ p["ro"]

    return stage_fn, pre_fn, post_fn


def params_from_flax_pipeline(flax_params) -> Tuple[Any, Any, Any]:
    """The reference's ``(stage_params, pre_params, post_params)`` (numpy
    leaves; the stage leaves stacked over P·V) → the port's."""
    stacked, pre, post = flax_params
    n = np.asarray(tree_leaves_np(stacked)[0]).shape[0]
    per_layer = []
    for i in range(n):
        one = _index_np(stacked, i)
        sd = params_from_flax({"embed": {"embedding": np.zeros((1, 1))},
                               "pos_embed": np.zeros((1, 1)), "h0": one})
        per_layer.append({k[len("h.0."):]: v for k, v in sd.items() if k.startswith("h.0.")})
    stage = {k: torch.stack([sd[k] for sd in per_layer]) for k in per_layer[0]}
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    return (stage, {"emb": as_t(pre["emb"]), "pos": as_t(pre["pos"])},
            {"ro": as_t(post["ro"])})


def tree_leaves_np(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves_np(v)]
    return [tree]


def _index_np(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index_np(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def reference_forward(fns, params, toks) -> torch.Tensor:
    """The same stack applied sequentially — the numerics oracle."""
    stage_fn, pre_fn, post_fn = fns
    stage_params, pre_params, post_params = params
    h = pre_fn(pre_params, toks)
    n = tree_leaves(stage_params)[0].shape[0]
    for i in range(n):
        h = stage_fn(tree_map(lambda a: a[i], stage_params), h)
    return post_fn(post_params, h)


def make_pp_train_step(fns, mesh, *, n_microbatches, virtual_stages):
    """(loss, grads) over the pipeline: next-token cross-entropy, the mean
    over every rank's tokens. ``toks`` is this rank's ``dp`` shard; the
    gradients are the whole stack's (summed over ``pp`` and ``dp``), the
    same on every rank, and so is the loss."""
    stage_fn, pre_fn, post_fn = fns
    data = axes_group(mesh, ("dp",))
    both = axes_group(mesh, ("dp", "pp"))
    dp = axis_size(mesh, "dp")

    def train_step(params, toks):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        stage_params, pre_params, post_params = tree_map(lambda _: next(it), params)
        logits = pipeline_apply(
            stage_fn, stage_params, toks, mesh=mesh, n_microbatches=n_microbatches,
            virtual_stages=virtual_stages, pre_fn=pre_fn, pre_params=pre_params,
            post_fn=post_fn, post_params=post_params)
        xent = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1), reduction="sum")
        share = xent / (toks.shape[0] * dp * (toks.shape[1] - 1))
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        flat = coll.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), both)
        parts = iter(flat.split([g.numel() for g in grads]))
        out = tree_map(lambda p: next(parts).view_as(p), params)
        return coll.all_reduce_(share.detach().clone(), data), out

    return train_step
