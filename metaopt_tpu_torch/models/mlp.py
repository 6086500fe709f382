"""MLP classifier — BASELINE config 2 (TPE on MLP/MNIST, 4 hparams).

Port of ``metaopt_tpu/models/mlp.py``. Searchable hparams: ``lr``
(loguniform), ``width`` (discrete), ``depth`` (discrete), ``dropout``
(uniform). The hidden layers' matmuls run in bf16 on ``cuda`` and in f32
on the CPU (the reference takes bf16 on the TPU, f32 elsewhere); the head
runs in f32. Dropout masks come from an explicit ``torch.Generator``, never
the global one. Weights are initialized in flax's distributions from a
seed; ``params_from_flax`` loads a flax ``MLP``'s parameters instead.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metaopt_tpu_torch.models.data import synthetic_images
from metaopt_tpu_torch.models.transformer import init_dense_like_flax
from metaopt_tpu_torch.utils.device import resolve_device


def _matmul_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class MLP(nn.Module):
    """``depth`` hidden ``nn.Linear`` layers of ``width`` with ReLU and
    dropout, then a linear head to ``n_classes`` logits."""

    def __init__(self, width: int, depth: int, dropout: float = 0.0,
                 n_classes: int = 10, in_features: int = 28 * 28):
        super().__init__()
        dims = [in_features] + [width] * depth
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], n_classes)
        self.dropout = float(dropout)

    @torch.no_grad()
    def init_like_flax(self, generator: torch.Generator) -> "MLP":
        """Re-initialize as flax's ``Dense`` does (truncated lecun-normal
        kernels, zero biases) from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_dense_like_flax(mod, generator)
        return self

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = _matmul_dtype(x.device)
        x = x.reshape(x.shape[0], -1).to(dtype)
        keep = 1.0 - self.dropout
        for lin in self.hidden:
            x = F.relu(F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype)))
            if train and self.dropout > 0.0:
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, 0.0)
        return F.linear(x.to(torch.float32), self.head.weight, self.head.bias)


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``MLP``'s ``params`` tree (``Dense_i`` with ``kernel`` (in,
    out) and ``bias``) as this module's ``state_dict``: ``weight`` is the
    kernel transposed to (out, in); the last ``Dense`` is the head."""
    names = sorted(flax_params, key=lambda k: int(k.split("_")[1]))
    out = {}
    for i, name in enumerate(names):
        prefix = "head" if i == len(names) - 1 else f"hidden.{i}"
        p = flax_params[name]
        out[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["kernel"], np.float32).T.copy())
        out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    return out


class Adam:
    """Adam as ``optax.adam`` (and ``torch.optim.Adam``) computes it, in
    ``torch._foreach`` ops over the model's parameters.

    ``torch.optim``'s first optimizer in a process imports ``torch._dynamo``
    (hundreds of modules), and a trial run as its own process pays that once
    per trial; this class imports nothing.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.mu, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.mu, denom,
                                value=-self.lr / (1.0 - self.b1 ** self.count))


def loss_fn(model: MLP, x: torch.Tensor, y: torch.Tensor, *, train: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(model(x, train=train, generator=generator), y)


def train_and_eval(
    hparams: Dict[str, Any],
    *,
    n_train: int = 8192,
    n_val: int = 2048,
    batch_size: int = 256,
    epochs: int = 3,
    seed: int = 0,
    device=None,
    report: Optional[Dict[str, Any]] = None,
) -> float:
    """Train with Adam on synthetic MNIST-shaped data, one permutation per
    epoch; return the validation error rate.

    ``report``, when given, receives ``train_s`` (seconds of the step loop,
    device-synchronized), ``steps``, ``losses`` (mean per epoch),
    ``setup_s`` (model, data and optimizer before the loop),
    ``optimizer_init_s`` (constructing the optimizer, of ``setup_s``) and
    ``trial_s`` (the whole call).
    """
    t_call = time.perf_counter()
    device = resolve_device(device)
    model = MLP(int(hparams["width"]), int(hparams["depth"]),
                float(hparams.get("dropout", 0.0)))
    model.init_like_flax(torch.Generator().manual_seed(seed)).to(device)
    x, y = synthetic_images(n_train, seed=2 * seed, device=device)
    xv, yv = synthetic_images(n_val, seed=2 * seed + 1, device=device)
    t_opt = time.perf_counter()
    opt = Adam(model.parameters(), lr=float(hparams["lr"]))
    optimizer_init_s = time.perf_counter() - t_opt
    gen = torch.Generator(device=device).manual_seed(seed)
    steps = n_train // batch_size

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    epoch_losses = []
    for _ in range(int(epochs)):
        perm = torch.randperm(n_train, generator=gen, device=device)
        idx = perm[: steps * batch_size].reshape(steps, batch_size)
        total = torch.zeros((), device=device)
        for ib in idx:
            loss = loss_fn(model, x[ib], y[ib], train=True, generator=gen)
            opt.zero_grad()
            loss.backward()
            opt.step()
            total += loss.detach()
        epoch_losses.append(total / steps)
    sync()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        err = 1.0 - (model(xv).argmax(-1) == yv).float().mean()
    err = float(err)
    if report is not None:
        report.update(train_s=train_s, steps=steps * int(epochs),
                      losses=[float(v) for v in epoch_losses],
                      setup_s=t0 - t_call, optimizer_init_s=optimizer_init_s,
                      trial_s=time.perf_counter() - t_call)
    return err


def make_objective(**fixed):
    """Objective for InProcessExecutor: params dict → validation error."""

    def objective(params: Dict[str, Any]) -> float:
        kw = dict(fixed)
        if "epochs" in params:
            kw["epochs"] = int(params["epochs"])  # fidelity axis
        return train_and_eval(params, **kw)

    return objective
